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

The bf16 model on f32 embeddings (what the data pipeline feeds these two
families): both archs at their bf16 smoke configs, the reference's params
carried over, f32 standard normal embeds (2, 32, D) and zero labels from
seed 0.  The reference's einsums promote the bf16 weights and keep the
activations f32; the port's ``apply_linear`` and ``bsr_matmul`` do the
same.  ``forward_embeds`` logits, ``loss_fn`` and ``make_prefill_step``'s
embeds branch (dense and at sparsity 0.8) are held to the family tests'
rtol = atol = 1e-4 (f32 activations over weights exact in f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (attn_impl, check_decode, check_forward,  # noqa: E402,F401
                             check_params_carry_over, check_prefill_step,
                             check_serve_cli, check_serve_engine,
                             check_sparse_forward, check_sparse_leaves,
                             make_model, moe_flags, one_torch_thread,
                             sparse_pair)
from _torch_families import TOL, to_numpy  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

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


# -- the bf16 model on f32 embeddings ----------------------------------------

@dataclasses.dataclass
class Bf16Model:
    ref_cfg: object
    cfg: object
    ref_params: dict
    params: dict
    embeds: np.ndarray   # (2, 32, D) f32
    labels: np.ndarray   # (2, 32) zeros


@pytest.fixture(scope="module", params=ARCHS)
def bf16_model(request):
    arch = request.param
    ref_cfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    assert cfg.dtype == "bfloat16"
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    return Bf16Model(ref_cfg, cfg, ref_params,
                     T.params_from_reference(to_numpy(ref_params), cfg,
                                             "cpu"),
                     embeds, np.zeros((2, 32), np.int32))


def test_f32_embeds_on_bf16_model_match_reference(bf16_model, attn_impl):
    """``forward_embeds`` and ``loss_fn`` keep f32 activations through the
    bf16 stack, as the reference's do."""
    m = bf16_model
    e = torch.from_numpy(m.embeds)
    want, _ = RT.forward_embeds(m.ref_params, jnp.asarray(m.embeds),
                                m.ref_cfg)
    got, _ = T.forward_embeds(m.params, e, m.cfg)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_loss = RT.loss_fn(m.ref_params, None, jnp.asarray(m.labels),
                           m.ref_cfg, embeds=jnp.asarray(m.embeds))
    got_loss = T.loss_fn(m.params, None, torch.from_numpy(m.labels), m.cfg,
                         embeds=e)
    assert np.isfinite(float(got_loss))
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_f32_embeds_prefill_step_on_bf16_model(bf16_model, sparse):
    """``make_prefill_step``'s embeds branch; sparse: the reference's f32
    tiles carried over as the model's bf16 (exact), under f32 x."""
    m = bf16_model
    ref_params, params = m.ref_params, m.params
    if sparse:
        ref_params = ref_serve.sparsify_params(m.ref_params, m.ref_cfg, 0.8,
                                               min_dim=64)
        params = T.params_from_reference(to_numpy(ref_params), m.cfg, "cpu")
    want_logits, want_h = ref_steps.make_prefill_step(m.ref_cfg)(
        ref_params, {"embeds": jnp.asarray(m.embeds)})
    got_logits, got_h = steps.make_prefill_step(m.cfg)(
        params, {"embeds": torch.from_numpy(m.embeds)})
    assert got_h.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
