"""The port's Mamba2 and hybrid families against the JAX package's:
Mamba2-2.7B (attention-free, 4 SSD layers at its smoke config, chunk 8)
and Jamba-1.5-Large (Mamba2 and attention 3:1, MoE every other layer,
8 layers as two periods of four), each at its f32 smoke config
(``_torch_families``: rtol = atol = 1e-4).

For each arch: the params carry over with the reference's dtypes (a_log,
d_skip, dt_bias stay f32) and the port draws the same tree; ``forward``
(the chunked SSD scan over 16 chunks) under ``chunked`` and ``flash``;
16 ``decode_step``s (the one-step recurrence and the conv tail in the
state); all again at sparsity 0.8; ``make_prefill_step``; ``ServeEngine``
against the reference's, token for token (neither engine resets a slot's
recurrent state between waves); the serving CLI.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_families import (attn_impl, check_decode, check_forward,  # noqa: E402,F401
                             check_params_carry_over, check_prefill_step,
                             check_serve_cli, check_serve_engine,
                             check_sparse_forward, check_sparse_leaves,
                             make_model, moe_flags, one_torch_thread,
                             sparse_pair)
from repro.models import transformer as RT  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
# BCSR leaves at sparsity 0.8, min_dim 64: mamba2 in_proj and out_proj of
# 4 layers; jamba in_proj and out_proj of its 6 Mamba2 layers (d_model 64,
# d_inner 128), none of its attention projections (64 x 32 kv) but wq and
# wo of its 2 attention layers, and the MLPs of its 4 odd layers (the MoE
# layers' experts stay dense)
N_BCSR = {"mamba2-2.7b": 8, "jamba-1.5-large-398b": 6 * 2 + 2 * 2 + 4 * 3}


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


def test_state_layout_matches_reference(model):
    """Each Mamba2 layer's state: the SSM state (B, nh, ns, hd) in f32 and
    the conv tail (B, w - 1, d_inner + 2 ns) in the model's dtype, as the
    reference's ``init_mamba2_state``; attention layers keep a KV cache."""
    cfg = model.cfg
    cache = T.init_cache(cfg, 2, 8, "cpu")
    ref_cache = RT.init_cache(model.ref_cfg, 2, 8)
    ref_layers = [ref_cache["prefix"][i] for i in range(len(
        ref_cache["prefix"]))]
    prefix, period, nblocks = T.stage_plan(cfg)
    for bi in range(nblocks):
        for j in range(len(period)):
            ref_layers.append({k: np.asarray(v)[bi] for k, v in
                               ref_cache["stack"][f"sub{j}"].items()})
    assert len(ref_layers) == len(cache["layers"])
    for desc, got, want in zip(T.layer_descs(cfg), cache["layers"],
                               ref_layers):
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            assert tuple(leaf.shape) == np.asarray(want[name]).shape, name
            assert str(leaf.dtype).split(".")[-1] == \
                str(np.asarray(want[name]).dtype), name
        if desc.kind == "ssm":
            assert got["ssm"].dtype == torch.float32
