"""``method="auto"`` on the port's engine against the JAX package's.

Reduced-channel slices of AlexNet and ResNet-50 (the first dense-kept conv
and the first two sparse ones, stride 1, 12 px, as the reference's
``tests/test_tuning.py`` builds them), the same seeded numpy weights in
both packages (the port's through ``params_from_reference``), and the same
plan: the port's forward (the kernels' plain versions on the CPU) against
the reference's (its Pallas kernels in interpret mode) within
1e-4 x max(1, max |y|), both summing in f32 in different orders.  The
plans cover the ELL kernel fused, pipelined and permuted, quantised and
not, the BCSR kernel at block heights 32 and 64 in f32, int8 and e4m3,
and a ``csr-direct`` entry.  The engine's two plan fallbacks and its
execution reports are held to the reference's, field by field.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import telemetry as ref_telemetry  # noqa: E402
from repro import tuning as ref_tuning  # noqa: E402
from repro.engine import CnnEngine as RefEngine  # noqa: E402
from repro.engine import lower as ref_lower  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.engine import CnnEngine, lower  # noqa: E402
from repro_torch.engine import params_from_reference, spec  # noqa: E402
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel  # noqa: E402
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.telemetry import SparseFallbackWarning  # noqa: E402
from repro_torch.tuning import PlanEntry  # noqa: E402

IMAGE = 12
REPORT_FIELDS = ("name", "method_planned", "method_executed", "provenance",
                 "plan_source", "fallback_reason", "fuse", "value_dtype")


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, ref_telemetry):
        t.disable()
        t.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for t in (telemetry, ref_telemetry):
        t.disable()
        t.reset()


def _slice(net_name):
    """The reference's ``tests/test_tuning.py`` slice, in both packages'
    spec vocabularies."""
    full = ref_cnn.NETWORKS[net_name]()
    convs = [l for l, _ in ref_cnn.conv_layer_shapes(full, 3, 224)]
    picked = ([next(l for l in convs if l.sparsity == 0)]
              + [l for l in convs if l.sparsity > 0][:2])
    ref_net, net = [], []
    for l in picked:
        l = dataclasses.replace(l, out_c=max(8, min(32, l.out_c // 8)),
                                stride=1)
        ref_net += [l, ref_cnn.Relu()]
        net += [spec.Conv(l.name, l.out_c, l.k, l.stride, l.pad,
                          sparsity=l.sparsity), spec.Relu()]
    return ref_net, net


def _setup(net_name, seed=3):
    ref_net, net = _slice(net_name)
    rng = np.random.default_rng(seed)
    ref_params = ref_cnn.init_cnn(ref_net, 3, rng, IMAGE)
    np_params = {k: (v if k == "_fc_rng" else
                     {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])})
                 for k, v in ref_params.items()}
    params = params_from_reference(np_params, device="cpu")
    x = rng.standard_normal((2, 3, IMAGE, IMAGE)).astype(np.float32)
    sparse = [l.name for l in ref_net
              if isinstance(l, ref_cnn.Conv) and l.sparsity > 0]
    return (ref_lower(ref_net, (3, IMAGE, IMAGE)), ref_params,
            lower(net, (3, IMAGE, IMAGE)), params, x, sparse)


# each plan: entries for the slice's two sparse convs
PLANS = {
    "ell-fused-pipelined-permuted+bsr32-int8": (
        dict(method="pallas", tm=8, pad_to=8, fuse=True, pipeline=True,
             permute=True),
        dict(method="bsr", block_m=32, block_n=128, fuse=True,
             value_dtype="int8")),
    "bsr64+csr-direct": (
        dict(method="bsr", block_m=64, block_n=128, fuse=True),
        dict(method="csr-direct", pad_to=4)),
    "ell-int8-blocking-unfused+bsr64-fp8": (
        dict(method="pallas", tm=8, pad_to=8, value_dtype="int8",
             pipeline=False),
        dict(method="bsr", block_m=64, block_n=128, fuse=False,
             value_dtype="float8_e4m3fn")),
    "ell-fp8-permuted+lowered": (
        dict(method="pallas", tm=16, pad_to=8, fuse=True, permute=True,
             value_dtype="float8_e4m3fn"),
        dict(method="lowered", pad_to=16)),
}


def _plans(sparse, entries):
    port = {n: PlanEntry(**d) for n, d in zip(sparse, entries)}
    ref = {n: ref_tuning.PlanEntry(**d) for n, d in zip(sparse, entries)}
    return port, ref


def _close(got, want):
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


@pytest.mark.parametrize("plan_name", sorted(PLANS))
@pytest.mark.parametrize("net_name", ["alexnet", "resnet50"])
def test_auto_matches_the_references_auto_under_one_plan(net_name,
                                                         plan_name):
    ref_prog, ref_params, prog, params, x, sparse = _setup(net_name)
    plan, ref_plan = _plans(sparse, PLANS[plan_name])
    ref_tuning.apply_plan_to_params(ref_params, ref_plan)
    tuning.apply_plan_to_params(params, plan)
    want = RefEngine(ref_prog, ref_params, ref_plan)(jnp.asarray(x), "auto")
    launches = (sparse_conv_kernel.launches, bsr_conv_kernel.launches)
    got = CnnEngine(prog, params, plan, device="cpu")(x, "auto")
    assert (sparse_conv_kernel.launches, bsr_conv_kernel.launches) == \
        launches   # the CPU runs the plain versions
    _close(got, want)


@pytest.mark.parametrize("net_name", ["alexnet", "resnet50"])
def test_auto_without_a_plan_matches_dense(net_name):
    _, _, prog, params, x, _ = _setup(net_name)
    eng = CnnEngine(prog, params, device="cpu")
    _close(eng(x, "auto"), eng(x, "dense"))
    assert set(eng._auto_plans) == {2}
    assert all(pe.method in ("dense", "pallas", "bsr")
               for pe in eng._auto_plans[2].values())


@pytest.mark.parametrize("plan_name", ["ell-fused-pipelined-permuted+bsr32-int8",
                                       "ell-int8-blocking-unfused+bsr64-fp8",
                                       "ell-fp8-permuted+lowered"])
def test_quantise_and_balance_in_the_forward(plan_name):
    """A plan the params were not rebuilt for: the engine balances and
    quantises the bound f32 banks itself (once), bit for bit the banks
    ``apply_plan_to_params`` builds, and the reference's in-trace path
    within tolerance."""
    ref_prog, ref_params, prog, params, x, sparse = _setup("alexnet")
    plan, ref_plan = _plans(sparse, PLANS[plan_name])
    want = RefEngine(ref_prog, ref_params, ref_plan)(jnp.asarray(x), "auto")
    eng = CnnEngine(prog, params, plan, device="cpu")
    got = eng(x, "auto")
    _close(got, want)
    made = dict(eng._derived)
    assert made   # balanced or quantised here, not by the params
    torch.testing.assert_close(eng(x, "auto"), got, rtol=0, atol=0)
    assert all(eng._derived[k][1] is v[1] for k, v in made.items())
    built = {k: dict(v) if isinstance(v, dict) else v
             for k, v in params.items()}
    tuning.apply_plan_to_params(built, plan)
    prebuilt = CnnEngine(prog, built, plan, device="cpu")(x, "auto")
    torch.testing.assert_close(prebuilt, got, rtol=0, atol=0)


def _reports(ref_engine, engine, shape):
    ref_rep = ref_engine.execution_report(shape, "auto")
    rep = engine.execution_report(shape, "auto")
    assert len(rep.ops) == len(ref_rep.ops)
    for o, r in zip(rep.ops, ref_rep.ops):
        for f in REPORT_FIELDS:
            assert getattr(o, f) == getattr(r, f), (o.name, f)
    assert rep.fallback_count == ref_rep.fallback_count
    return rep, ref_rep


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_execution_report_is_the_references(plan_name):
    ref_prog, ref_params, prog, params, x, sparse = _setup("resnet50")
    plan, ref_plan = _plans(sparse, PLANS[plan_name])
    ref_tuning.apply_plan_to_params(ref_params, ref_plan)
    tuning.apply_plan_to_params(params, plan)
    eng = CnnEngine(prog, params, plan, device="cpu")
    rep, _ = _reports(RefEngine(ref_prog, ref_params, ref_plan), eng,
                      x.shape)
    assert rep.fallback_count == 0 and not rep.jit_cache_hit
    for o in rep.ops:
        if o.method_executed == "pallas":
            assert {"tm", "tp", "cc", "rows", "pipeline"} <= set(o.tiling)
        if o.method_executed == "bsr":
            assert o.tiling["n_tile"] % o.tiling["block_m"] == 0
        assert o.est_s > 0 and o.flops > 0 and o.hbm_bytes > 0
    eng(x, "auto")
    assert eng.execution_report(x.shape, "auto").jit_cache_hit


def test_stale_bsr_and_value_dtype_mismatch_fall_back_as_the_reference():
    ref_prog, ref_params, prog, params, x, sparse = _setup("resnet50")
    # the params carry int8 banks for both sparse convs
    built, ref_built = _plans(sparse, (
        dict(method="pallas", tm=8, pad_to=8, value_dtype="int8"),
        dict(method="bsr", block_m=32, block_n=128, value_dtype="int8")))
    tuning.apply_plan_to_params(params, built)
    ref_tuning.apply_plan_to_params(ref_params, ref_built)
    # ... and the plan asks for a bsr entry with no block shape (a pre-v5
    # cache) and for an fp8 stream the int8 bank cannot give
    plan, ref_plan = _plans(sparse, (
        dict(method="bsr"),
        dict(method="bsr", block_m=32, block_n=128,
             value_dtype="float8_e4m3fn")))
    eng = CnnEngine(prog, params, plan, device="cpu")
    ref_eng = RefEngine(ref_prog, ref_params, ref_plan)
    rep, _ = _reports(ref_eng, eng, x.shape)
    assert [o.fallback_reason for o in rep.ops if o.fell_back] == [
        "stale_plan_no_block", "value_dtype_mismatch"]
    with telemetry.enabled(), ref_telemetry.enabled():
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            y = eng(x, "auto")
        want = ref_eng(jnp.asarray(x), "auto")
        snap = {k: v for k, v in telemetry.snapshot().items()
                if k.startswith(("fallback.", "engine."))}
        ref_snap = {k: v for k, v in ref_telemetry.snapshot().items()
                    if k.startswith(("fallback.", "engine."))}
    assert snap == ref_snap
    assert snap["fallback.engine.value_dtype_mismatch"]["value"] == 1
    assert sorted(str(w.message) for w in got_w
                  if issubclass(w.category, SparseFallbackWarning)) == sorted(
        f"engine: layer {n!r} (m={o.m} c={o.c} e={o.e} f={o.f}) fell back "
        f"-> dense: {r}" for n, o, r in zip(
            sparse, [o for o in prog.conv_ops if o.sparsity > 0],
            ("stale_plan_no_block", "value_dtype_mismatch")))
    _close(y, want)
    assert eng.last_report.fallback_count == 2


def test_a_pinned_tile_the_card_lacks_raises():
    """The reference would fall back (``nondividing_tm``); the port names the
    layer and the reason."""
    _, _, prog, params, x, sparse = _setup("alexnet")
    plan = {sparse[0]: PlanEntry(method="pallas", tm=4, pad_to=8)}
    eng = CnnEngine(prog, params, plan, device="cpu")
    with pytest.raises(ValueError, match=f"{sparse[0]}.*unsupported_tm"):
        eng.execution_report(x.shape, "auto")
    with pytest.raises(ValueError, match=f"{sparse[0]}.*unsupported_tm"):
        eng(x, "auto")


def test_cnn_forward_takes_a_plan():
    _, _, _, params, x, sparse = _setup("alexnet")
    _, net = _slice("alexnet")
    plan, _ = _plans(sparse, PLANS["bsr64+csr-direct"])
    eng = cnn.engine_for(net, params, x.shape[1:], plan, device="cpu")
    assert eng.plan is plan
    assert cnn.engine_for(net, params, x.shape[1:], plan,
                          device="cpu") is eng
    assert cnn.engine_for(net, params, x.shape[1:], device="cpu") is not eng
    y = cnn.cnn_forward(net, params, x, "auto", plan=plan, device="cpu")
    _close(y, cnn.cnn_forward(net, params, x, "dense", device="cpu"))
