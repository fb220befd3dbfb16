"""The port's MoE and MLA families against the JAX package's: OLMoE
(64 experts top-8 at full width; here its smoke config, 8 experts top-2)
and DeepSeek-V3 (MLA attention, one leading dense layer, 8 experts top-2
with a shared expert), each at its f32 smoke config (``_torch_families``
holds the shared setup and tolerances: rtol = atol = 1e-4).

For each arch: the params carry over with the reference's dtypes and the
port draws the same tree; ``forward`` under ``chunked`` and ``flash``
(MLA's 48/32 head dims take the chunked path in both packages, the
reference's rule); 16 ``decode_step``s (DeepSeek's through the absorbed
MLA decode over its latent cache); all again at sparsity 0.8, the
reference's banks carried over and the port's own; ``make_prefill_step``;
``ServeEngine`` against the reference's, token for token; the serving CLI.

Sparse MLA decode: with ``min_dim`` 16 ``k_b`` and ``v_b`` become BCSR,
and the reference's absorbed decode cannot reshape them
(``AttributeError``); the port raises a ``ValueError`` naming the layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (attn_impl, check_decode, check_forward,  # noqa: E402,F401
                             check_params_carry_over, check_prefill_step,
                             check_serve_cli, check_serve_engine,
                             check_sparse_forward, check_sparse_leaves,
                             decode_both, make_model, moe_flags,
                             one_torch_thread, sparse_pair)
from repro.models import transformer as RT  # noqa: E402
from repro_torch.core.sparse_format import BcsrMatrix  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
# BCSR leaves of the port's per-layer tree at sparsity 0.8, min_dim 64:
# olmoe the four attention projections of 3 layers (the experts are
# stacked (E, in, out) banks and stay dense, as the reference's 4-D
# stacked experts do); deepseek q_a, q_b, wo in 4 layers, the leading
# layer's MLP and the 3 MoE layers' shared expert (kv_a, k_b, v_b are
# below min_dim at the smoke width), and its MTP head: proj, the block's
# q_a, q_b, wo and MLP
N_BCSR = {"olmoe-1b-7b": 12, "deepseek-v3-671b": 4 * 3 + 3 + 3 * 3 + 7}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return make_model(request.param)


@pytest.fixture(scope="module")
def sparse(model):
    return sparse_pair(model)


def test_params_carry_over_per_layer(model):
    check_params_carry_over(model)


def test_forward_matches_reference(model, attn_impl):
    check_forward(model)


def test_decode_steps_match_reference(model):
    check_decode(model)


def test_sparsify_params_builds_the_reference_tiles(model, sparse):
    _, carried, own = sparse
    assert check_sparse_leaves(carried, own) == N_BCSR[model.cfg.name[:-6]]


def test_sparse_forward_matches_reference(model, sparse, attn_impl):
    check_sparse_forward(model, sparse)


def test_sparse_decode_matches_reference(model, sparse):
    ref_sparse, carried, own = sparse
    for params in (carried, own):
        check_decode(model, ref_sparse, params)


def test_prefill_step_matches_reference(model, sparse, attn_impl):
    check_prefill_step(model, sparse)


def test_serve_engine_matches_reference_tokens(model, sparse):
    ref_sparse, carried, _ = sparse
    check_serve_engine(model, ref_sparse, carried)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    check_serve_cli(arch, capsys)


def test_sparse_mla_decode_raises_in_both_packages():
    """At ``min_dim`` 16 the MLA up-projections k_b and v_b are BCSR: the
    reference's absorbed decode raises at its reshape, the port's names
    the layer and the reason; its prefill still runs."""
    m = make_model("deepseek-v3-671b")
    ref_sparse, carried, own = sparse_pair(m, min_dim=16)
    for params in (carried, own):
        assert all(isinstance(layer["mixer"][name], BcsrMatrix)
                   for layer in params["layers"] for name in ("k_b", "v_b"))
    with pytest.raises(AttributeError, match="reshape"):
        RT.decode_step(ref_sparse, m.ref_cfg, jnp.asarray(m.toks[:, :1]),
                       RT.init_cache(m.ref_cfg, 2, 4), jnp.int32(0))
    for params in (carried, own):
        with pytest.raises(ValueError, match=r"layer 0: the absorbed MLA "
                           r"decode reads k_b .* the reference cannot "
                           r"decode it either"):
            T.decode_step(params, m.cfg, torch.from_numpy(m.toks[:, :1]),
                          T.init_cache(m.cfg, 2, 4, "cpu"), 0)
    want, _ = RT.forward(ref_sparse, jnp.asarray(m.toks), m.ref_cfg)
    got, _ = T.forward(own, torch.from_numpy(m.toks), m.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_mla_cache_is_the_latent():
    """The MLA layers cache (B, S, kv_lora_rank) and (B, S, rope) in the
    model's dtype, as the reference's ``init_mla_cache``; a decode step
    writes position cur_len of both in place."""
    m = make_model("deepseek-v3-671b")
    cfg = m.cfg
    cache = T.init_cache(cfg, 2, 8, "cpu")
    ref_cache = RT.init_cache(m.ref_cfg, 2, 8)
    for layer in cache["layers"]:
        assert layer["c_kv"].shape == (2, 8, cfg.kv_lora_rank)
        assert layer["k_rope"].shape == (2, 8, cfg.qk_rope_head_dim)
    assert np.asarray(ref_cache["prefix"][0]["c_kv"]).shape == \
        tuple(cache["layers"][0]["c_kv"].shape)
    T.decode_step(m.params, cfg, torch.from_numpy(m.toks[:, :1]), cache, 3)
    for layer in cache["layers"]:
        assert bool(layer["c_kv"][:, 3].abs().sum() > 0)
        assert int(layer["c_kv"][:, :3].count_nonzero()) == 0
        assert int(layer["c_kv"][:, 4:].count_nonzero()) == 0


def test_decode_steps_consistent_with_forward():
    """The reference's decode-consistency check on the port alone: at a
    capacity factor that drops no token, 16 decode steps reproduce the
    full-sequence forward (the absorbed MLA decode against the expanded
    prefill) within rtol = atol = 1e-2, argmax agreeing at >= 0.95 of the
    positions."""
    from repro_torch.models import flags

    for arch in ARCHS:
        m = make_model(arch)
        flags.set_moe_capacity(8.0)
        toks = torch.from_numpy(m.toks[:, :16])
        full, _ = T.forward(m.params, toks, m.cfg)
        cache = T.init_cache(m.cfg, 2, 16, "cpu")
        got = torch.stack([T.decode_step(m.params, m.cfg, toks[:, i:i + 1],
                                         cache, i)[0] for i in range(16)], 1)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-2,
                                   atol=1e-2)
        assert float((got.argmax(-1) == full.argmax(-1)).float().mean()) \
            >= 0.95
