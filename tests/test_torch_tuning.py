"""The port's autotuner against the JAX package: cache keys, the plan-cache
file format both ways, the shipped broken-cache fixtures, the banks a plan
builds, the quantised-stream byte credit and the ``quantize`` opt-in, and
the planner's dedup and cache-hit counters.

Both packages see the same seeded numpy weights (the port's through
``params_from_reference``) and the same lowered programs, and the port
plans with the reference's backend name (``"cpu"``) wherever the two are
compared key for key.  Banks built by ``apply_plan_to_params`` are compared
bit for bit (values as bytes, scales, indices, permutations).
"""
import dataclasses
import glob
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro import telemetry as ref_telemetry  # noqa: E402
from repro import tuning as ref_tuning  # noqa: E402
from repro.engine import lower as ref_lower  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.engine import lower, params_from_reference  # noqa: E402
from repro_torch.engine import spec  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.tuning import (Candidate, ConvGeometry, PlanCache,  # noqa: E402
                                PlanEntry, candidate_cost, layer_key,
                                plan_layer, plan_program, roofline_estimate)
from repro_torch.tuning.cache import PlanCacheWarning  # noqa: E402
from repro_torch.tuning.measure import TimingStats, time_fn  # noqa: E402
from repro_torch.tuning.space import (VALUE_DTYPES,  # noqa: E402
                                      allowed_value_dtypes,
                                      enumerate_candidates)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "plan_caches")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Both packages' telemetry is process-global: start and end clean."""
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


def _geom(**kw):
    base = dict(name="l", m=64, c=32, h=14, w=14, r=3, s=3, stride=1, pad=1,
                sparsity=0.7, batch=2)
    base.update(kw)
    return ConvGeometry(**base), ref_tuning.ConvGeometry(**base)


GEOMS = [dict(), dict(relu=True), dict(residual=True, relu=True),
         dict(sparsity=0.62, batch=8, dtype="bfloat16"),
         dict(m=256, c=1024, h=7, w=7, r=1, s=1, pad=0, stride=2,
              sparsity=0.9)]


@pytest.mark.parametrize("kw", GEOMS, ids=str)
@pytest.mark.parametrize("backend", ["cpu", "cuda", "tpu"])
def test_layer_key_is_the_references(kw, backend):
    g, rg = _geom(**kw)
    assert layer_key(g, backend) == ref_tuning.layer_key(rg, backend)
    assert tuning.sparsity_bucket(g.sparsity) == \
        ref_tuning.sparsity_bucket(g.sparsity)


ENTRIES = {
    "a": dict(method="pallas", tm=8, pad_to=8, fuse=True, pipeline=True,
              permute=True, value_dtype="int8", est_s=1e-5,
              source="roofline"),
    "b": dict(method="bsr", block_m=32, block_n=128, fuse=True,
              value_dtype="float8_e4m3fn", est_s=2e-5, source="measured"),
    "c": dict(method="csr-direct", pad_to=4, est_s=3e-5),
    "d": dict(method="dense", source="heuristic"),
}


def test_v6_cache_written_by_either_package_loads_in_the_other(tmp_path):
    port = PlanCache(str(tmp_path / "port.json"))
    ref = ref_tuning.PlanCache(str(tmp_path / "ref.json"))
    for k, d in ENTRIES.items():
        port.put(k, PlanEntry(**d))
        ref.put(k, ref_tuning.PlanEntry(**d))
    port.save()
    ref.save()
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    back_ref = ref_tuning.PlanCache(str(tmp_path / "port.json"))
    back_port = PlanCache(str(tmp_path / "ref.json"))
    for k in ENTRIES:
        assert back_ref.get(k).to_dict() == port.get(k).to_dict()
        assert back_port.get(k) == port.get(k)
        assert back_port.get(k).provenance == "cache_hit"


def _load_both(path):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        port = PlanCache(path)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref = ref_tuning.PlanCache(path)
    return port, ref, got_w, ref_w


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(FIXTURES, "*.json"))), ids=os.path.basename)
def test_fixture_caches_load_migrate_and_warn_as_the_reference(path):
    port, ref, got_w, ref_w = _load_both(path)
    assert sorted(port.entries) == sorted(ref.entries)
    for k, e in port.entries.items():
        assert e.to_dict() == ref.entries[k].to_dict()
        assert e.provenance == ref.entries[k].provenance
    assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
    assert all(issubclass(w.category, PlanCacheWarning) for w in got_w)


@pytest.mark.parametrize("text", ["{not json", "[1, 2]",
                                  '{"version": 99, "entries": {}}',
                                  '{"version": 6, "entries": {"k": 1}}'])
def test_broken_caches_warn_as_the_reference(tmp_path, text):
    path = tmp_path / "bad.json"
    path.write_text(text)
    port, ref, got_w, ref_w = _load_both(str(path))
    assert len(port) == len(ref) == 0
    assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
    assert got_w
    with pytest.raises((ValueError, json.JSONDecodeError)):
        PlanCache().load(str(path), strict=True)


def test_migration_counters_match_the_reference(tmp_path):
    path = tmp_path / "v4.json"
    path.write_text(open(os.path.join(FIXTURES, "stale_v4_bsr.json")).read())
    with telemetry.enabled(), ref_telemetry.enabled():
        PlanCache(str(path))
        ref_tuning.PlanCache(str(path))
        assert telemetry.snapshot() == ref_telemetry.snapshot()


# -- the banks a plan builds ----------------------------------------------

def _slice_params(seed=11):
    net = [ref_cnn.Conv("c0", 8, 3, 1, 1, sparsity=0.0), ref_cnn.Relu(),
           ref_cnn.Conv("c1", 40, 3, 1, 1, sparsity=0.7), ref_cnn.Relu(),
           ref_cnn.Conv("c2", 70, 3, 1, 1, sparsity=0.8), ref_cnn.Relu(),
           ref_cnn.Conv("c3", 24, 1, 1, 0, sparsity=0.6)]
    ref_params = ref_cnn.init_cnn(net, 3, np.random.default_rng(seed), 10)
    np_params = {k: (v if k == "_fc_rng" else
                     {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])})
                 for k, v in ref_params.items()}
    return net, ref_params, params_from_reference(np_params, device="cpu")


PLANS = [
    {"c1": dict(method="pallas", tm=8, pad_to=8, permute=True,
                value_dtype="int8"),
     "c2": dict(method="bsr", block_m=32, block_n=128, value_dtype="int8"),
     "c3": dict(method="lowered", pad_to=16)},
    {"c1": dict(method="bsr", block_m=64, block_n=128),
     "c2": dict(method="pallas", tm=16, pad_to=4),
     "c3": dict(method="csr-direct", pad_to=4)},
    {"c1": dict(method="bsr"),   # a stale entry: no block, nothing built
     "c2": dict(method="pallas", tm=8, value_dtype="float8_e4m3fn"),
     "c3": dict(method="bsr", block_m=8, block_n=128,
                value_dtype="float8_e4m3fn")},
]


def _np(t):
    t = t.contiguous()
    if t.dtype in (torch.int8, torch.float8_e4m3fn):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _ref_np(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_apply_plan_builds_the_references_banks(plan):
    _, ref_params, params = _slice_params()
    ref_tuning.apply_plan_to_params(
        ref_params, {k: ref_tuning.PlanEntry(**d) for k, d in plan.items()})
    tuning.apply_plan_to_params(
        params, {k: PlanEntry(**d) for k, d in plan.items()})
    for name in plan:
        got, want = params[name], ref_params[name]
        assert sorted(got) == sorted(want)
        for key in ("ell_auto", "ell2d_auto", "bcsr_auto"):
            if key not in want:
                continue
            for f in dataclasses.fields(want[key]):
                a, b = getattr(got[key], f.name), getattr(want[key], f.name)
                if isinstance(a, torch.Tensor):
                    np.testing.assert_array_equal(_np(a), _ref_np(b))
                elif b is None or isinstance(b, (tuple, int)):
                    assert a == b or (a is None and b is None), f.name
    # safe to call again
    tuning.apply_plan_to_params(
        params, {k: PlanEntry(**d) for k, d in plan.items()})


# -- the candidate space and the roofline ----------------------------------

def test_candidate_space_default_is_f32_only():
    g, _ = _geom()
    assert {c.value_dtype for c in enumerate_candidates(g)} == {"float32"}
    cands = enumerate_candidates(g, value_dtypes=VALUE_DTYPES)
    for method in ("pallas", "bsr"):
        assert ({c.value_dtype for c in cands if c.method == method}
                == set(VALUE_DTYPES))
    assert all(c.value_dtype == "float32" for c in cands
               if c.method not in ("pallas", "bsr"))
    # the card's axes: te/tf unset; tm from the ELL kernel's tiles; pad_to
    # only where padding is work
    for c in cands:
        assert c.te is None and c.tf is None
        if c.method == "pallas":
            assert c.pad_to is None
            assert c.tm in {t for t, _ in budget.ELL_TILES}
        if c.method in ("lowered", "csr-direct"):
            assert c.pad_to in tuning.PAD_TO_BUCKETS
    assert {(c.block_m, c.block_n) for c in cands if c.method == "bsr"} == \
        {(8, 128), (16, 128), (32, 128), (64, 128)}


def test_one_by_one_layers_have_one_ell_schedule():
    g, _ = _geom(r=1, s=1, pad=0)
    assert not any(c.pipeline for c in enumerate_candidates(g)
                   if c.method == "pallas")


def test_dense_layer_space_is_dense_only():
    g, _ = _geom(sparsity=0.0)
    assert enumerate_candidates(g) == [Candidate("dense")]


def test_allowed_value_dtypes_backend_policy():
    """The card converts e4m3 (and the kernels decode it exactly): all
    three; elsewhere the reference's policy, no fp8."""
    assert allowed_value_dtypes("cuda") == VALUE_DTYPES
    assert allowed_value_dtypes("tpu") == \
        ref_tuning.space.allowed_value_dtypes("tpu")
    for backend in ("cpu", "gpu"):
        assert allowed_value_dtypes(backend) == \
            ref_tuning.space.allowed_value_dtypes(backend)


def test_roofline_credits_quantised_value_stream():
    """Port of the reference's test: same schedule, narrower values, fewer
    bytes for both kernels, by the reference's byte credit; on a
    weight-bound geometry the bound drops too."""
    g, _ = _geom(m=256, c=256, h=28, w=28, sparsity=0.9)
    pallas = Candidate("pallas", tm=8, pad_to=8)
    bsr = Candidate("bsr", block_m=8, block_n=128)
    for cand in (pallas, bsr):
        q = dataclasses.replace(cand, value_dtype="int8")
        assert (candidate_cost(g, q)["hbm_bytes"]
                < candidate_cost(g, cand)["hbm_bytes"])
        # the narrow values plus a scale row, the reference's accounting
        ref_q = ref_tuning.measure.candidate_cost(
            _geom(m=256, c=256, h=28, w=28, sparsity=0.9)[1],
            ref_tuning.Candidate(**q.to_dict()))
        ref_f = ref_tuning.measure.candidate_cost(
            _geom(m=256, c=256, h=28, w=28, sparsity=0.9)[1],
            ref_tuning.Candidate(**cand.to_dict()))
        assert (candidate_cost(g, cand)["hbm_bytes"]
                - candidate_cost(g, q)["hbm_bytes"]) == pytest.approx(
            ref_f["hbm_bytes"] - ref_q["hbm_bytes"])
    # weight-bound on the card (its ELL rate is the card's, not the TPU's,
    # so the reference's 7 x 7 map is compute-bound here): a 2 x 2 map
    g_wb, _ = _geom(m=512, c=512, h=2, w=2, sparsity=0.9, batch=1)
    for cand in (pallas, bsr):
        q = dataclasses.replace(cand, value_dtype="int8")
        assert roofline_estimate(g_wb, q) < roofline_estimate(g_wb, cand)


def test_bsr_quantised_takes_two_products():
    g, _ = _geom(m=256, c=256, h=28, w=28, sparsity=0.5, batch=8)
    f32 = Candidate("bsr", block_m=8, block_n=128, fuse=True)
    q = dataclasses.replace(f32, value_dtype="int8")
    t_f32 = tuning.measure._bsr_terms(g, f32)[0]
    t_q = tuning.measure._bsr_terms(g, q)[0]
    assert t_q == pytest.approx(t_f32 * 2 / 3)


def test_plan_layer_quantize_opt_in():
    """Port of the reference's test: never a narrow dtype unless asked; with
    quantize=True the smaller value stream wins on a memory-bound layer;
    only the card may pin fp8."""
    g, _ = _geom(m=256, c=256, h=28, w=28, sparsity=0.9)
    assert plan_layer(g, mode="roofline").value_dtype == "float32"
    pe = plan_layer(g, mode="roofline", quantize=True)
    assert pe.method in ("pallas", "bsr")
    assert pe.value_dtype == "int8"   # cpu backend: fp8 filtered out
    pe_cuda = plan_layer(g, mode="roofline", backend="cuda", quantize=True)
    assert pe_cuda.value_dtype in ("int8", "float8_e4m3fn")


def test_plan_layer_prices_plain_methods_above_the_kernels():
    """``lowered`` and ``csr-direct`` are plain PyTorch loops on the card:
    one pass over the output a padded slot, so a layer of any size plans a
    kernel."""
    for kw in (dict(), dict(m=256, c=256, h=56, w=56, batch=8)):
        g, _ = _geom(**kw)
        pe = plan_layer(g, mode="roofline", backend="cuda")
        assert pe.method in ("pallas", "bsr"), pe


def test_wall_mode_measures_on_the_cpu_without_the_kernels():
    """On the CPU the kernels run their plain versions: wall mode measures
    only dense, lowered and csr-direct there (the reference's rule off its
    accelerator), and records a measured source."""
    net = [spec.Conv("c1", 8, 3, 1, 1, sparsity=0.7), spec.Relu()]
    from repro_torch.models import cnn
    params = cnn.init_cnn(net, 4, np.random.default_rng(0), 8, device="cpu")
    plan = tuning.plan_network(net, 4, 8, batch=1, mode="wall",
                               cache=PlanCache(), params=params, iters=1,
                               device="cpu")
    assert plan["c1"].source == "measured"
    assert plan["c1"].method in ("dense", "lowered", "csr-direct")
    assert not tuning.measurable(Candidate("bsr", block_m=8, block_n=128),
                                 "cpu")
    assert tuning.measurable(Candidate("pallas", tm=8), "cuda")


def test_time_fn_returns_spread():
    calls = []
    t = time_fn(lambda: calls.append(1), warmup=2, iters=5)
    assert isinstance(t, TimingStats) and len(calls) == 7
    assert t.min <= float(t) <= t.max and t.spread >= 0


# -- the planner's dedup and counters ---------------------------------------

def _dedup_nets(mod):
    body = lambda i: mod.Residual(body=(                      # noqa: E731
        mod.Conv(f"b{i}/1x1a", 16, 1, sparsity=0.7), mod.Relu(),
        mod.Conv(f"b{i}/1x1b", 16, 1, sparsity=0.7)))
    return [mod.Conv("stem", 16, 3, 1, 1, sparsity=0.0), mod.Relu(),
            body(0), mod.Relu(), body(1), mod.Relu()]


def test_plan_program_dedups_on_op_geometry(monkeypatch):
    import repro_torch.tuning.planner as planner_mod
    program = lower(_dedup_nets(spec), (3, 12, 12))
    calls = []
    orig = planner_mod.plan_layer
    monkeypatch.setattr(planner_mod, "plan_layer",
                        lambda g, **kw: calls.append(g.name) or orig(g, **kw))
    plan = planner_mod.plan_program(program, batch=1, backend="cpu")
    assert len(plan) == 5 and len(calls) == 2
    assert plan["b0/1x1a"] == plan["b1/1x1a"]
    assert plan["b0/1x1b"] == plan["b1/1x1b"]


@pytest.mark.parametrize("with_params", [False, True])
def test_plan_counters_match_the_reference(tmp_path, with_params):
    """The same program planned by both packages, cold and then from the
    saved file (and an untagged legacy cache read by a weights-aware plan):
    the tuning.plan.* and tuning.cache.* counters agree."""
    ref_net = _dedup_nets(ref_cnn)
    ref_prog = ref_lower(ref_net, (3, 12, 12))
    prog = lower(_dedup_nets(spec), (3, 12, 12))
    ref_params = ref_cnn.init_cnn(ref_net, 3, np.random.default_rng(3), 12)
    params = params_from_reference(
        {k: (v if k == "_fc_rng" else {"w": np.asarray(v["w"]),
                                       "b": np.asarray(v["b"])})
         for k, v in ref_params.items()}, device="cpu")
    kw_port = dict(params=params if with_params else None, backend="cpu")
    kw_ref = dict(params=ref_params if with_params else None, backend="cpu")
    paths = (str(tmp_path / "port.json"), str(tmp_path / "ref.json"))
    with telemetry.enabled(), ref_telemetry.enabled():
        # a weight-free run leaves untagged entries for the tagged run
        plan_program(prog, cache=PlanCache(paths[0]), backend="cpu")
        ref_tuning.plan_program(ref_prog, cache=ref_tuning.PlanCache(
            paths[1]), backend="cpu")
        for _ in range(2):
            p = plan_program(prog, cache=PlanCache(paths[0]), **kw_port)
            r = ref_tuning.plan_program(
                ref_prog, cache=ref_tuning.PlanCache(paths[1]), **kw_ref)
        snap = {k: v for k, v in telemetry.snapshot().items()
                if k.startswith("tuning.")}
        ref_snap = {k: v for k, v in ref_telemetry.snapshot().items()
                    if k.startswith("tuning.")}
    assert snap == ref_snap
    assert snap["tuning.plan.cache_hit"]["value"] > 0
    assert sorted(p) == sorted(r)
    assert sorted(json.load(open(paths[0]))["entries"]) == \
        sorted(json.load(open(paths[1]))["entries"])
