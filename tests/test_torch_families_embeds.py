"""The port's encoder and VLM families against the JAX package's:
HuBERT-XLarge (encoder-only, bidirectional attention, GELU MLP; head dim
80 at full width, 16 here) and Phi-3-Vision (the phi3-mini decoder over
precomputed patch embeddings; head dim 96 at full width, 16 here), each at
its f32 smoke config (``_torch_families``: rtol = atol = 1e-4).

``forward_embeds`` on the same (B, 128, D) embeddings under ``chunked``
and ``flash`` (non-causal for HuBERT), dense and at sparsity 0.8 (the
reference's banks carried over and the port's own), and
``make_prefill_step`` on embeddings; Phi-3-Vision also decodes 16 tokens
and serves through ``ServeEngine``.  The encoder has no decode step: the
serving CLI refuses it, as the reference's does.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (attn_impl, check_decode, check_forward,  # noqa: E402,F401
                             check_params_carry_over, check_prefill_step,
                             check_serve_cli, check_serve_engine,
                             check_sparse_forward, check_sparse_leaves,
                             make_model, moe_flags, one_torch_thread,
                             sparse_pair)
from repro_torch.launch import serve  # noqa: E402

ARCHS = ["hubert-xlarge", "phi-3-vision-4.2b"]
# BCSR leaves at sparsity 0.8, min_dim 64: the 3 layers' four attention
# projections (64 x 64) and MLP (two for HuBERT's GELU, three for
# Phi-3's SwiGLU)
N_BCSR = {"hubert-xlarge": 3 * (4 + 2), "phi-3-vision-4.2b": 3 * (4 + 3)}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return make_model(request.param)


@pytest.fixture(scope="module")
def sparse(model):
    return sparse_pair(model)


def test_params_carry_over_per_layer(model):
    check_params_carry_over(model)


def test_forward_embeds_matches_reference(model, attn_impl):
    assert model.cfg.causal == (model.cfg.family != "encoder")
    check_forward(model)


def test_sparsify_params_builds_the_reference_tiles(model, sparse):
    _, carried, own = sparse
    assert check_sparse_leaves(carried, own) == N_BCSR[model.cfg.name[:-6]]


def test_sparse_forward_embeds_matches_reference(model, sparse, attn_impl):
    check_sparse_forward(model, sparse)


def test_prefill_step_on_embeds_matches_reference(model, sparse, attn_impl):
    check_prefill_step(model, sparse)


def test_vlm_decode_steps_match_reference():
    m = make_model("phi-3-vision-4.2b")
    check_decode(m)
    ref_sparse, carried, own = sparse_pair(m)
    for params in (carried, own):
        check_decode(m, ref_sparse, params)
    check_serve_engine(m, ref_sparse, carried)


def test_serve_cli(capsys):
    check_serve_cli("phi-3-vision-4.2b", capsys)
    with pytest.raises(SystemExit, match="encoder-only arch has no decode "
                       "step"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_serve_sparse_llm_example_runs_on_the_cpu(capsys):
    """The port's LLM serving example: dense, then sparse, through the
    serving CLI in this process."""
    from repro_torch.examples import serve_sparse_llm

    serve_sparse_llm.main(["--arch", "phi-3-vision-4.2b", "--batch", "2",
                           "--gen", "3", "--prompt-len", "4", "--device",
                           "cpu"])
    out = capsys.readouterr().out
    assert "sparsity=0.0" in out and "sparsity=0.8" in out
    assert out.count("generated 3 tokens x 2 seqs on cpu") == 2
