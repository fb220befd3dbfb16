"""The port's MoE layer against the JAX package's ``_moe_group`` and
``moe_fwd``, on f32 weights from the reference's ``init_moe``.

The reference builds its dispatch index arrays inside ``_moe_group`` and
returns only the output, so the test reads them from its own products: a
spy on ``jnp.einsum`` records the dispatched (E, C, D) tokens and the
per-k (G, K, D) expert outputs, and each row is matched to the token (or
expert slot) it was gathered from; a zero row is the sentinel (an empty
slot, or the trash slot of an assignment dropped over capacity).  The
port's ``token_for_slot`` and ``slot_for_tokk`` must equal those exactly
(the trash entry of ``token_for_slot`` aside: the reference scatters every
dropped token there and no gather reads it; the port leaves the sentinel),
with no drops and with drops (a small capacity), and the outputs must
agree within rtol = atol = 1e-5 (f32 sums in another order).  ``moe_fwd``
with ``group_size`` (two groups, each its own capacity) and with a shared
expert, within the same tolerance; the capacity rule against the capacity
the reference's dispatch buffer has.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import flags as ref_flags  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _flags():
    saved = (ref_flags.MOE_CAPACITY, ref_flags.MOE_IMPL, flags.MOE_CAPACITY)
    ref_flags.set_moe_capacity(1.25)
    ref_flags.set_moe_impl("gather")
    flags.set_moe_capacity(1.25)
    yield
    ref_flags.MOE_CAPACITY, ref_flags.MOE_IMPL = saved[:2]
    flags.MOE_CAPACITY = saved[2]


def _cfgs(arch):
    return (dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(configs.get_config(arch, smoke=True),
                                dtype="float32"))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _layer(arch, seed=0):
    ref_cfg, cfg = _cfgs(arch)
    ref_p = RL.init_moe(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    return ref_cfg, cfg, ref_p, _torch_tree(jax.tree.map(np.asarray, ref_p))


class _EinsumSpy:
    """Records (spec, operands, result) of every ``jnp.einsum`` call (under
    the reference's group scan, tracers: their shapes only are read)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self._real = jnp.einsum
        monkeypatch.setattr(jnp, "einsum", self)

    def __call__(self, spec, *ops, **kw):
        out = self._real(spec, *ops, **kw)
        self.calls.append((spec, list(ops), out))
        return out

    def find(self, spec):
        return [c for c in self.calls if c[0] == spec]


def _match_rows(rows, table, sentinel):
    """Index of each row of ``rows`` in ``table`` (exact), ``sentinel``
    for a zero row."""
    out = []
    for r in rows:
        if not r.any():
            out.append(sentinel)
            continue
        hit = np.flatnonzero((table == r).all(axis=1))
        assert len(hit) == 1, hit
        out.append(int(hit[0]))
    return np.asarray(out)


def _reference_arrays(spy, g, e, cap):
    """token_for_slot[:E * C] and slot_for_tokk of the reference's last
    ``_moe_group`` call, read from its einsums."""
    (_, (dispatched, _), _), = spy.find("ecd,edf->ecf")[-2:-1]
    (_, _, y), = spy.find("ecf,efd->ecd")[-1:]
    (_, (_, per_k), _), = spy.find("gk,gkd->gd")[-1:]
    dispatched, y, per_k = (np.asarray(a) for a in (dispatched, y, per_k))
    d = dispatched.shape[-1]
    assert dispatched.shape == (e, cap, d)
    return (dispatched.reshape(e * cap, d), y.reshape(e * cap, d),
            per_k.reshape(-1, d))


@pytest.mark.parametrize("arch, g, factor", [
    ("olmoe-1b-7b", 64, 4.0),      # capacity 32: no assignment dropped
    ("olmoe-1b-7b", 64, 0.5),      # capacity 8 of a mean 16: drops
    ("deepseek-v3-671b", 48, 0.6)])
def test_moe_group_index_arrays_equal_the_reference(monkeypatch, arch, g,
                                                    factor):
    ref_cfg, cfg, ref_p, p = _layer(arch)
    e, k = cfg.n_experts, cfg.top_k
    cap = L.moe_capacity(g, cfg, factor)
    xg = np.random.default_rng(g).standard_normal(
        (g, cfg.d_model)).astype(np.float32)
    spy = _EinsumSpy(monkeypatch)
    want = np.asarray(RL._moe_group(ref_p, jnp.asarray(xg), ref_cfg, cap))
    dispatched, y, per_k = _reference_arrays(spy, g, e, cap)
    want_tfs = _match_rows(dispatched, xg, g)
    want_sft = _match_rows(per_k, y, e * cap)

    topw, tfs, sft, kept = L.moe_route(p, torch.from_numpy(xg), cfg, cap)
    np.testing.assert_array_equal(tfs[:e * cap].numpy(), want_tfs)
    assert int(tfs[e * cap]) == g
    np.testing.assert_array_equal(sft.numpy(), want_sft)
    dropped = int((sft == e * cap).sum())
    assert dropped == g * k - int(kept.sum())
    if factor < 1:
        assert dropped > 0
    else:
        assert dropped == 0
    got = L._moe_group(p, torch.from_numpy(xg), cfg, cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("group_size", [None, 16, 24])
def test_moe_fwd_matches_reference(monkeypatch, arch, group_size):
    """One group, two groups of 16 (each its own capacity), and 24, which
    does not divide 32 tokens (one group, as in the reference); the
    capacity the port computes is the reference's dispatch buffer's;
    deepseek adds its shared expert."""
    ref_cfg, cfg, ref_p, p = _layer(arch, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    spy = _EinsumSpy(monkeypatch)
    want = RL.moe_fwd(ref_p, jnp.asarray(x), ref_cfg, group_size=group_size,
                      capacity_factor=0.9)
    gsz = 16 if group_size == 16 else 32
    cap = spy.find("ecd,edf->ecf")[-1][1][0].shape[1]
    assert cap == L.moe_capacity(gsz, cfg, 0.9)
    got = L.moe_fwd(p, torch.from_numpy(x), cfg, group_size=group_size,
                    capacity_factor=0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g, factor", [(8, 1.25), (64, 1.25), (8192, 1.25),
                                       (100, 0.3), (4, 8.0)])
def test_capacity_rule(g, factor):
    """int(g k / E f), rounded up to a multiple of 8, at least 8: OLMoE's
    prefill of 8192 tokens (64 experts top-8) gets 1280 slots an expert,
    a decode step of 4 tokens 8."""
    cfg = configs.get_config("olmoe-1b-7b")
    cap = int(g * cfg.top_k / cfg.n_experts * factor)
    assert L.moe_capacity(g, cfg, factor) == max(8, -(-cap // 8) * 8)
    assert L.moe_capacity(8192, cfg, 1.25) == 1280
    assert L.moe_capacity(4, cfg, 1.25) == 8


def test_moe_flags_default_to_the_reference():
    assert flags.MOE_CAPACITY == ref_flags.MOE_CAPACITY == 1.25


def _bf16_tree(tree):
    """The reference's bf16 leaves as bf16 tensors (through f32, exact),
    its f32 leaves (the router) as f32."""
    if isinstance(tree, dict):
        return {k: _bf16_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    t = torch.from_numpy(np.asarray(a.astype(np.float32)))
    return t if a.dtype == np.float32 else t.to(torch.bfloat16)


@pytest.mark.parametrize("arch, g, factor", [
    ("olmoe-1b-7b", 64, 4.0),
    ("olmoe-1b-7b", 64, 0.5),
    ("deepseek-v3-671b", 48, 0.6)])
def test_moe_group_bf16_rounds_as_the_reference(arch, g, factor):
    """A bf16 layer: the expert products' f32 results are rounded to bf16
    only where the reference rounds them (the SwiGLU product and the down
    product), not the gate and up products.  Every element within one
    bf16 rounding plus 1e-4 x max |want| (an element whose f32 sums, in
    another order, round to the neighbouring bf16 value), and at most 1 %
    of elements differ at all: rounding hg and hu to bf16 first moves
    about half of them."""
    ref_cfg, cfg = (ref_configs.get_config(arch, smoke=True),
                    configs.get_config(arch, smoke=True))
    ref_p = RL.init_moe(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    p = _bf16_tree(ref_p)
    assert p["w_gate"].dtype == torch.bfloat16
    assert p["router"].dtype == torch.float32
    xb = jnp.asarray(np.random.default_rng(g).standard_normal(
        (g, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    cap = L.moe_capacity(g, cfg, factor)
    want = np.asarray(RL._moe_group(ref_p, xb, ref_cfg, cap)
                      .astype(jnp.float32))
    xg = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = L._moe_group(p, xg, cfg, cap)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    excess = np.abs(got - want) - (2.0 ** -8 * np.abs(want) + 1e-4 * scale)
    assert excess.max() <= 0.0, excess.max()
    assert (got != want).mean() <= 0.01, (got != want).mean()


def test_init_moe_draws_the_reference_tree():
    """The port's ``init_moe``: the reference's leaves, shapes and dtypes
    (the router f32 in a bf16 layer), expert banks drawn one expert at a
    time at d_in**-0.5."""
    ref_cfg, cfg = _cfgs("deepseek-v3-671b")
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    ref_p = RL.init_moe(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    p = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                   "cpu")
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    from repro_torch.tree import tree_paths
    flat = dict(tree_paths(p))
    assert sorted(flat) == sorted(flat_ref)
    for name, leaf in flat.items():
        assert tuple(leaf.shape) == flat_ref[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(flat_ref[name].dtype)
    w = p["w_gate"].float()
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-2
    assert abs(float(w.std()) - 0.88 * cfg.d_model ** -0.5) < 0.1 * \
        cfg.d_model ** -0.5
