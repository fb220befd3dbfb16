"""The port's fault-tolerant CNN serving tier against the JAX package's.

Every case of ``tests/test_serving_robust.py``, ported (admission control,
the degradation ladder, retry and backoff classification, overload,
escalation and recovery, the seeded chaos harness's zero-lost bar,
telemetry names, the plan-cache corruption seam), on the CPU
(``device="cpu"``: the conv kernels' plain versions).  On top of them:

* the chaos harness's draws (``arrival_trace``, every ``ChaosInjector``
  draw) are bit for bit the reference's for seeds 0-3;
* the same run in both packages: the same slice net and params (the
  reference's, carried across by ``params_from_reference``), the same
  pinned plan with ``pallas`` entries, the same trace and chaos seed, on
  ``VirtualClock`` with ``min_tick_s`` = 1e-3 s, above both packages'
  roofline ``est_s`` at 12 px (the port prices the card, the reference its
  own target, so below it the two clocks would tick differently).  The
  ``SloReport``s are equal, with dropped rungs' rule ids and reasons read
  through ``RULE_MAP``; each request's status, reason and rung are equal;
  each completed result lies within 1e-4 x max(1, max |y|) of the
  reference's on f32 rungs and within a relative norm of 0.05 on the int8
  rung;
* ``Backoff``, and ``FailureDetector`` on the CUDA errors a serve step can
  raise;
* ``python -m repro_torch.launch.serve --cnn-serve --chaos --device cpu``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as ref_serving  # noqa: E402
from repro import telemetry as ref_telemetry  # noqa: E402
from repro.engine import init_conv_params as ref_init  # noqa: E402
from repro.engine import lower as ref_lower  # noqa: E402
from repro.tuning import PlanEntry as RefPlanEntry  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.engine import (NoKernelSchedule,  # noqa: E402
                                init_conv_params, lower,
                                params_from_reference)
from repro_torch.runtime import Backoff, FailureDetector  # noqa: E402
from repro_torch.serving import (REJECT_REASONS, BucketSpec,  # noqa: E402
                                 ChaosConfig, ChaosFatalError, ChaosInjector,
                                 ChaosRetryableError, InferenceRequest,
                                 RobustCnnServer, VirtualClock, WallClock,
                                 arrival_trace, corrupt_plan_cache_file,
                                 slice_net)
from repro_torch.tuning import PlanEntry  # noqa: E402

NETS = ("alexnet", "googlenet", "resnet50")
DEV = "cpu"


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


class ScriptedChaos:
    """Chaos stand-in with a scripted fault sequence: deterministic tests
    drive exact retry/escalate paths through the production machinery."""

    def __init__(self, faults=()):
        self.faults = list(faults)

    def draw_step_fault(self):
        return self.faults.pop(0) if self.faults else None

    def inflate_tick(self, dt):
        return dt, False

    def corrupt_plan(self, plan, program):
        return plan


@pytest.fixture(scope="module")
def alex():
    net = slice_net("alexnet")
    params = init_conv_params(lower(net, (3, 12, 12)),
                              np.random.default_rng(0), device=DEV)
    return net, params


def _server(alex, **kw):
    net, params = alex
    kw.setdefault("clock", VirtualClock())
    kw.setdefault("queue_depth", 8)
    kw.setdefault("device", DEV)
    buckets = kw.pop("buckets", [BucketSpec(3, 12, 12, batch=2)])
    return RobustCnnServer(net, params, buckets, **kw)


def _req(rid, shape=(3, 12, 12), **kw):
    return InferenceRequest(rid=rid, shape=shape, **kw)


# -- ladder construction ----------------------------------------------------

@pytest.mark.parametrize("name", NETS)
def test_ladder_builds_and_verifies_clean(name):
    net = slice_net(name)
    params = init_conv_params(lower(net, (3, 12, 12)),
                              np.random.default_rng(0), device=DEV)
    srv = RobustCnnServer(net, params, [BucketSpec(3, 12, 12, batch=2)],
                          clock=VirtualClock(), device=DEV)
    (bucket,) = srv._buckets
    names = [r.name for r in bucket.rungs]
    assert names[0] == "tuned" and names[-1] == "dense"
    assert not srv.dropped_rungs
    for rung in bucket.rungs:
        # Every served rung passed the static gate: no silent fallbacks.
        assert rung.report.fallback_count == 0
        assert rung.report.rung == rung.name
        assert rung.est_s > 0


def test_quantised_rung_narrows_sparse_entries(alex):
    srv = _server(alex)
    (bucket,) = srv._buckets
    by_name = {r.name: r for r in bucket.rungs}
    if "quantised" in by_name:
        q = by_name["quantised"].plan
        assert any(pe.value_dtype == "int8" for pe in q.values()
                   if pe.method in ("pallas", "bsr"))
    dense = by_name["dense"].plan
    assert all(pe.method == "dense" for pe in dense.values())


def _pallas_plan(program, _batch):
    """Every sparse conv of the slice pinned to the ELL kernel: a plan the
    chaos harness corrupts whatever the roofline picks (on the card it
    picks ``bsr`` everywhere, which the harness leaves alone)."""
    return {op.name: PlanEntry(method="pallas", tm=8, fuse=True,
                               pipeline=True) if op.sparsity > 0
            else PlanEntry(method="dense")
            for op in program.conv_ops}


def test_corrupted_plan_drops_rung_not_service(alex):
    """A chaos-corrupted (statically infeasible) tuned plan is caught by
    the build-time verifier: the rung is dropped, traffic runs the next
    rung down, nothing is lost."""
    chaos = ChaosInjector(ChaosConfig(seed=0, plan_corruption_rate=1.0))
    srv = _server(alex, chaos=chaos, plan=_pallas_plan)
    (bucket,) = srv._buckets
    assert chaos.corrupted_entries
    assert srv.dropped_rungs
    assert all(d["preflight_errors"] or d["fallback_reasons"]
               for d in srv.dropped_rungs)
    assert {r for d in srv.dropped_rungs for r in d["preflight_errors"]} == {
        "sched.unsupported_tm"}
    assert "tuned" not in [r.name for r in bucket.rungs]
    rep = srv.run_trace(arrival_trace(6, [(3, 12, 12)], seed=1)).verify()
    assert rep.completed == 6


def test_a_rung_the_verifier_passes_but_the_card_refuses_propagates(
        alex, monkeypatch):
    """A blind verifier must not turn into a silently dropped rung: the
    engine's refusal propagates out of the ladder build."""
    from repro_torch.analysis import checker

    monkeypatch.setattr(checker, "preflight", lambda *a, **kw: [])
    chaos = ChaosInjector(ChaosConfig(seed=0, plan_corruption_rate=1.0))
    with pytest.raises(NoKernelSchedule, match="unsupported_tm"):
        _server(alex, chaos=chaos, plan=_pallas_plan)


# -- admission control ------------------------------------------------------

def test_rejection_no_bucket(alex):
    srv = _server(alex)
    r = _req(0, shape=(1, 12, 12))  # channel count no bucket serves
    assert srv.submit(r) is False
    assert r.status == "rejected" and r.reject_reason == "no_bucket"


def test_rejection_queue_full(alex):
    srv = _server(alex, queue_depth=2)
    rs = [_req(i) for i in range(4)]
    admitted = [srv.submit(r) for r in rs]
    assert admitted == [True, True, False, False]
    assert rs[2].reject_reason == rs[3].reject_reason == "queue_full"
    assert all(r in REJECT_REASONS for r in ("queue_full", "no_bucket"))


def test_rejection_deadline_expired(alex):
    srv = _server(alex)
    r = _req(0, deadline_s=0.001)
    srv.submit(r)
    srv.clock.advance(1.0)  # deadline passes while queued
    srv.tick()
    assert r.status == "rejected" and r.reject_reason == "deadline_expired"


def test_smaller_shapes_pad_into_bucket(alex):
    srv = _server(alex)
    x = np.random.default_rng(0).standard_normal((3, 10, 10)).astype(
        np.float32)
    r = InferenceRequest(rid=0, x=x)
    srv.submit(r)
    srv.tick()
    assert r.status == "done" and r.result is not None
    assert r.bucket == "3x12x12b2"
    assert isinstance(r.result, np.ndarray)   # copied to the host


def test_drain_exhausted_rejects_leftovers(alex):
    srv = _server(alex)
    trace = arrival_trace(10, [(3, 12, 12)], seed=0, mean_gap_s=0.0,
                          deadline_s=None)
    rep = srv.run_trace(trace, max_ticks=2).verify()  # budget too small
    assert rep.rejected.get("drain_exhausted", 0) > 0
    assert rep.lost == 0


# -- retry / failure classification -----------------------------------------

def test_retryable_fault_retries_then_completes(alex):
    srv = _server(alex, chaos=ScriptedChaos([
        ChaosRetryableError("UNAVAILABLE: injected (chaos)")]))
    r = _req(0)
    srv.submit(r)
    srv.tick()                      # faulted dispatch -> re-enqueued
    assert r.status == "queued" and r.attempts == 1
    assert r.not_before_s > srv.clock.now() - 1e-9
    srv.clock.advance(srv.backoff.delay_s(0))
    srv.tick()                      # backoff expired -> served
    assert r.status == "done"
    rep = srv.slo_report()
    assert rep.retries == 1 and rep.lost == 0


def test_retries_exhausted_rejects(alex):
    faults = [ChaosRetryableError("UNAVAILABLE: injected (chaos)")] * 5
    srv = _server(alex, chaos=ScriptedChaos(faults), max_attempts=2)
    r = _req(0)
    srv.submit(r)
    srv.tick()
    srv.clock.advance(10.0)
    srv.tick()
    assert r.status == "rejected" and r.reject_reason == "retries_exhausted"


def test_fatal_fault_rejects_immediately(alex):
    srv = _server(alex, chaos=ScriptedChaos([
        ChaosFatalError("injected device loss (chaos)")]))
    r = _req(0)
    srv.submit(r)
    srv.tick()
    assert r.status == "rejected" and r.reject_reason == "fatal_error"
    assert srv.slo_report().lost == 0


def test_backoff_policy_deterministic_and_capped():
    b = Backoff(base_s=0.1, mult=2.0, cap_s=0.5)
    assert [b.delay_s(i) for i in range(4)] == [0.1, 0.2, 0.4, 0.5]
    with pytest.raises(ValueError):
        Backoff(base_s=0.0)
    with pytest.raises(ValueError):
        Backoff(mult=0.5)


def test_backoff_is_the_references():
    from repro.runtime.fault_tolerance import Backoff as RefBackoff

    for kw in ({}, dict(base_s=0.01, mult=3.0, cap_s=0.2)):
        assert [Backoff(**kw).delay_s(i) for i in range(-1, 12)] == [
            RefBackoff(**kw).delay_s(i) for i in range(-1, 12)]


# the CUDA errors a serve step can raise, and how the detector must read
# them: a sticky error poisons the context (fatal), out of memory is fatal
# as the reference's RESOURCE_EXHAUSTED is, a collective (NCCL) timeout is
# transient, and cudaErrorDevicesUnavailable ("busy or unavailable")
# matches the UNAVAILABLE marker
CUDA_ERRORS = [
    (RuntimeError("CUDA error: an illegal memory access was encountered\n"
                  "CUDA kernel errors might be asynchronously reported at "
                  "some other API call"), "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.11 GiB of which 1.02 GiB is free."), "fatal"),
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout: "
                  "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 600000 "
                  "milliseconds before timing out."), "retryable"),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), "retryable"),
]


@pytest.mark.parametrize("exc, kind", CUDA_ERRORS,
                         ids=["illegal_address", "launch_failure", "oom",
                              "nccl_timeout", "devices_unavailable"])
def test_failure_detector_classifies_cuda_errors(exc, kind):
    from repro.runtime.fault_tolerance import \
        FailureDetector as RefFailureDetector

    assert FailureDetector().classify(exc) == kind
    assert RefFailureDetector().classify(exc) == kind


def test_a_cuda_fault_at_the_result_copy_is_classified(alex):
    """The serve step copies its result to the host inside its ``try``: a
    CUDA error that surfaces there (as an asynchronous one does) is
    classified by the detector, not raised out of the server."""
    srv = _server(alex)
    (bucket,) = srv._buckets
    real = bucket.engine

    class Faulty:
        def __init__(self, message):
            self.message = message

        def cpu(self):
            raise RuntimeError(self.message)

    for message, status, reason in (
            ("CUDA error: an illegal memory access was encountered",
             "rejected", "fatal_error"),
            ("CUDA error: CUDA-capable device(s) is/are busy or unavailable",
             "queued", None)):
        bucket.engine = lambda *a, **kw: Faulty(message)  # noqa: B023
        r = _req(len(srv.requests))
        srv.submit(r)
        srv.tick()
        assert (r.status, r.reject_reason) == (status, reason)
    bucket.engine = real
    srv.clock.advance(1.0)
    srv.tick()
    assert srv.requests[-1].status == "done"


# -- the degradation ladder at runtime --------------------------------------

def test_escalating_faults_step_down_then_recover(alex):
    """max_strikes consecutive retryable faults escalate: the bucket steps
    down a rung; a cool-down of healthy ticks steps it back up."""
    faults = [ChaosRetryableError("UNAVAILABLE: injected (chaos)")] * 3
    srv = _server(alex, chaos=ScriptedChaos(faults), max_strikes=3,
                  max_attempts=10, cooldown_ticks=2,
                  backoff=Backoff(base_s=0.001))
    (bucket,) = srv._buckets
    assert len(bucket.rungs) >= 2
    top = bucket.rungs[0].name
    r = _req(0)
    srv.submit(r)
    for _ in range(3):              # three strikes -> escalate
        srv.tick()
        srv.clock.advance(1.0)
    downs = [e for e in srv.events if e.reason == "escalate"]
    assert len(downs) == 1 and downs[0].from_rung == top
    assert bucket.rung_idx == 1
    # healthy ticks at the degraded rung recover the ladder
    srv.tick()                      # serves r at the degraded rung
    assert r.status == "done" and r.rung == bucket.rungs[1].name
    for i in range(3):
        r2 = _req(10 + i)
        srv.submit(r2)
        srv.tick()
    ups = [e for e in srv.events if e.reason == "recovered"]
    assert len(ups) == 1 and ups[0].to_rung == top
    assert bucket.rung_idx == 0


def test_overload_steps_down(alex):
    srv = _server(alex, queue_depth=4, high_water=0.5, cooldown_ticks=100)
    for i in range(4):
        srv.submit(_req(i))
    srv.tick()
    assert any(e.reason == "overload" for e in srv.events)


def test_rung_recorded_on_reports_and_requests(alex):
    srv = _server(alex)
    (bucket,) = srv._buckets
    r = _req(0)
    srv.submit(r)
    with telemetry.enabled():
        srv.tick()
        report = bucket.engine.last_report
    telemetry.reset()
    assert r.rung == bucket.rungs[0].name
    assert report.rung == r.rung
    assert report.to_dict()["rung"] == r.rung
    assert f"rung={r.rung}" in report.format()


# -- chaos acceptance -------------------------------------------------------

@pytest.mark.parametrize("name", NETS)
def test_heavy_chaos_trace_loses_nothing(name):
    """The acceptance bar: under seeded step faults, plan corruption, and
    stragglers, a heavy-traffic trace terminates every request exactly
    once, with machine-readable reasons on every rejection."""
    net = slice_net(name)
    params = init_conv_params(lower(net, (3, 12, 12)),
                              np.random.default_rng(0), device=DEV)
    chaos = ChaosInjector(ChaosConfig(
        seed=0, step_fault_rate=0.35, plan_corruption_rate=0.5,
        straggler_rate=0.2))
    srv = RobustCnnServer(net, params, [BucketSpec(3, 12, 12, batch=2)],
                          clock=VirtualClock(), queue_depth=16,
                          max_attempts=6, chaos=chaos, device=DEV,
                          plan=_pallas_plan)
    trace = arrival_trace(20, [(3, 12, 12), (3, 10, 10)], seed=2,
                          mean_gap_s=0.0005, deadline_s=(1.0, 2.0))
    rep = srv.run_trace(trace).verify()
    assert rep.submitted == 20
    assert rep.degradations or rep.dropped_rungs
    for r in srv.requests:
        assert r.status in ("done", "rejected")
        if r.status == "rejected":
            assert r.reject_reason in REJECT_REASONS
        else:
            assert r.rung is not None and r.result is not None


def test_chaos_replays_identically(alex):
    """Same seed, same workload -> identical SLO summary (the property the
    whole harness exists for)."""
    def run():
        srv = _server(alex, chaos=ChaosInjector(ChaosConfig(
            seed=5, step_fault_rate=0.4, straggler_rate=0.3)),
            max_attempts=6, queue_depth=16)
        trace = arrival_trace(15, [(3, 12, 12)], seed=3, mean_gap_s=0.001)
        return srv.run_trace(trace).verify().to_dict()

    assert run() == run()


def test_straggler_ticks_observed(alex):
    chaos = ChaosInjector(ChaosConfig(seed=1, straggler_rate=0.3,
                                      straggler_factor=50.0))
    srv = _server(alex, chaos=chaos, queue_depth=32)
    trace = arrival_trace(30, [(3, 12, 12)], seed=4, mean_gap_s=0.0,
                          deadline_s=None)
    rep = srv.run_trace(trace).verify()
    assert chaos.injected_stragglers > 0
    assert rep.straggler_ticks > 0


def test_telemetry_counters_namespaced(alex):
    telemetry.reset()
    with telemetry.enabled():
        srv = _server(alex, queue_depth=2)
        for i in range(4):
            srv.submit(_req(i, deadline_s=None))
        while srv.pending():
            srv.tick()
        snap = telemetry.snapshot()
    telemetry.reset()
    assert snap["serving.cnn.submitted"]["value"] == 4
    assert snap["serving.cnn.admitted"]["value"] == 2
    assert snap["serving.cnn.completed"]["value"] == 2
    assert snap["serving.cnn.rejected"]["value"] == 2
    assert snap["serving.cnn.rejected.queue_full"]["value"] == 2


def test_chaos_off_records_nothing(alex):
    telemetry.reset()
    srv = _server(alex)
    srv.submit(_req(0))
    srv.tick()
    assert telemetry.snapshot() == {}  # zero-overhead-when-off discipline


def test_wall_clock_trace_arrives_over_time(alex):
    """On a wall clock the trace's arrival times are offsets from the
    start of the run, not from the clock's epoch: a spaced trace is
    admitted over its span, not all at once."""
    srv = _server(alex, clock=WallClock())
    trace = arrival_trace(6, [(3, 12, 12)], seed=0, mean_gap_s=0.01,
                          deadline_s=None)
    rep = srv.run_trace(trace).verify()
    assert rep.completed == 6 and not rep.rejected
    first = min(r.submitted_s for r in srv.requests)
    last = max(r.submitted_s for r in srv.requests)
    assert last - first >= 0.5 * trace[-1].t_s


# -- plan-cache corruption seam ---------------------------------------------

@pytest.mark.parametrize("mode", ("garbage", "truncate", "bad_entry"))
def test_corrupt_plan_cache_degrades_resiliently(tmp_path, mode, alex):
    from repro_torch.tuning import PlanCache, plan_program
    from repro_torch.tuning.cache import PlanCacheWarning

    net, params = alex
    program = lower(net, (3, 12, 12))
    path = str(tmp_path / "plans.json")
    plan_program(program, batch=2, mode="roofline", cache=PlanCache(path),
                 params=params, device=DEV)
    corrupt_plan_cache_file(path, mode=mode)
    with pytest.warns(PlanCacheWarning):
        srv = RobustCnnServer(net, params, [BucketSpec(3, 12, 12, batch=2)],
                              plan_cache=path, clock=VirtualClock(),
                              device=DEV)
    rep = srv.run_trace(arrival_trace(4, [(3, 12, 12)], seed=0)).verify()
    assert rep.completed == 4


# -- the harness's draws are the reference's --------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_arrival_trace_is_the_references_bit_for_bit(seed):
    shapes = [(3, 224, 224), (3, 200, 200), (3, 160, 160)]
    for kw in ({}, dict(mean_gap_s=0.0125, deadline_s=(0.05, 0.5)),
               dict(deadline_s=None)):
        got = arrival_trace(50, shapes, seed=seed, **kw)
        want = ref_serving.arrival_trace(50, shapes, seed=seed, **kw)
        assert [(a.rid, a.t_s, a.shape, a.deadline_s) for a in got] == [
            (a.rid, a.t_s, a.shape, a.deadline_s) for a in want]


class _Op:
    def __init__(self, name, m):
        self.name, self.m = name, m


class _Program:
    conv_ops = tuple(_Op(f"c{i}", m) for i, m in
                     enumerate((64, 2, 192, 32, 16, 96, 128, 48)))


@pytest.mark.parametrize("seed", range(4))
def test_chaos_injector_draws_are_the_references(seed):
    """Step faults, stragglers and plan corruption, interleaved, draw the
    same numbers in the same order as the reference's injector."""
    cfg = dict(seed=seed, step_fault_rate=0.35, fatal_fault_rate=0.1,
               plan_corruption_rate=0.5, straggler_rate=0.2)
    port = ChaosInjector(ChaosConfig(**cfg))
    ref = ref_serving.ChaosInjector(ref_serving.ChaosConfig(**cfg))
    plan = {op.name: PlanEntry(method="pallas", tm=8)
            for op in _Program.conv_ops}
    ref_plan = {op.name: RefPlanEntry(method="pallas", tm=8)
                for op in _Program.conv_ops}
    got = [{n: pe.tm for n, pe in port.corrupt_plan(plan, _Program).items()}]
    want = [{n: pe.tm for n, pe in ref.corrupt_plan(ref_plan,
                                                    _Program).items()}]
    for i in range(200):
        if i % 3 == 2:
            got.append(port.inflate_tick(1e-3 * i))
            want.append(ref.inflate_tick(1e-3 * i))
        else:
            got.append(repr(port.draw_step_fault()))
            want.append(repr(ref.draw_step_fault()))
    assert got == want
    assert port.summary() == ref.summary()


# -- the same run in both packages -------------------------------------------

# the reference's rule id / fallback reason -> the port's, for a dropped
# rung: the corruption tm = m - 1 is a nondividing tile there and a tile
# the card's ELL kernel lacks here
RULE_MAP = {"sched.nondividing_tm": "sched.unsupported_tm",
            "nondividing_tm": "unsupported_tm"}
MIN_TICK_S = 1e-3
QUANT_REL_TOL = 0.05


def _map_report(d):
    d = dict(d)
    d["dropped_rungs"] = [
        dict(r, preflight_errors=[RULE_MAP.get(x, x)
                                  for x in r["preflight_errors"]],
             fallback_reasons=[RULE_MAP.get(x, x)
                               for x in r["fallback_reasons"]])
        for r in d["dropped_rungs"]]
    return d


@pytest.mark.parametrize("name", ["alexnet", "resnet50"])
def test_the_same_run_in_both_packages(name):
    """One chaos trace over two buckets, the first sparse conv pinned to
    the ELL kernel and the second to the BCSR one: the reference's
    ``SloReport`` and every request's fate and result."""
    ref_net = ref_serving.slice_net(name)
    net = slice_net(name)
    ref_params = ref_init(ref_lower(ref_net, (3, 12, 12)),
                          np.random.default_rng(0))
    params = params_from_reference(
        {k: (v if k == "_fc_rng" else {"w": np.asarray(v["w"]),
                                       "b": np.asarray(v["b"])})
         for k, v in ref_params.items()}, device=DEV)
    sparse = [l.name for l in ref_net if getattr(l, "sparsity", 0) > 0]
    pins = [dict(method="pallas", tm=8, fuse=True, pipeline=True),
            dict(method="bsr", block_m=8, block_n=128, fuse=True)]

    def plan_of(entry_cls):
        def make(program, _batch):
            out = {op.name: entry_cls(method="dense")
                   for op in program.conv_ops}
            out.update({n: entry_cls(**kw) for n, kw in zip(sparse, pins)})
            return out
        return make

    buckets = [(3, 12, 12, 2), (3, 16, 16, 2)]
    shapes = [(3, 12, 12), (3, 10, 10), (3, 16, 16)]
    trace = arrival_trace(24, shapes, seed=1, mean_gap_s=0.0005,
                          deadline_s=(1.0, 2.0))
    images = {a.rid: np.random.default_rng(100 + a.rid).standard_normal(
        a.shape).astype(np.float32) for a in trace}
    chaos = dict(seed=0, step_fault_rate=0.35, plan_corruption_rate=0.5,
                 straggler_rate=0.1)
    common = dict(queue_depth=16, max_attempts=6, cooldown_ticks=4,
                  min_tick_s=MIN_TICK_S)
    srv = RobustCnnServer(
        net, params, [BucketSpec(*b) for b in buckets],
        plan=plan_of(PlanEntry), clock=VirtualClock(), device=DEV,
        chaos=ChaosInjector(ChaosConfig(**chaos)), **common)
    ref_srv = ref_serving.RobustCnnServer(
        ref_net, ref_params, [ref_serving.BucketSpec(*b) for b in buckets],
        plan=plan_of(RefPlanEntry), clock=ref_serving.VirtualClock(),
        chaos=ref_serving.ChaosInjector(ref_serving.ChaosConfig(**chaos)),
        **common)
    # the premise of equal clocks: every rung's roofline cost lies below
    # the shared minimum tick in both packages
    for s in (srv, ref_srv):
        for b in s._buckets:
            assert all(r.report.est_s < MIN_TICK_S for r in b.rungs)
    rep = srv.run_trace(trace, request_factory=lambda a: InferenceRequest(
        rid=a.rid, x=images[a.rid], deadline_s=a.deadline_s)).verify()
    ref_rep = ref_srv.run_trace(
        trace, request_factory=lambda a: ref_serving.InferenceRequest(
            rid=a.rid, x=images[a.rid], deadline_s=a.deadline_s)).verify()
    assert rep.dropped_rungs and (rep.degradations or len(
        {d["bucket"] for d in rep.dropped_rungs}) < len(buckets))
    assert rep.to_dict() == _map_report(ref_rep.to_dict())
    assert rep.completed > 0
    quantised = 0
    for r, q in zip(srv.requests, ref_srv.requests):
        assert (r.rid, r.status, r.reject_reason, r.rung, r.bucket) == (
            q.rid, q.status, q.reject_reason, q.rung, q.bucket)
        if r.status != "done":
            continue
        want = np.asarray(q.result)
        if r.rung == "quantised":
            quantised += 1
            rel = np.linalg.norm(r.result - want) / np.linalg.norm(want)
            assert rel < QUANT_REL_TOL, (r.rid, rel)
        else:
            tol = 1e-4 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(r.result, want, rtol=0, atol=tol)


# -- the serving CLI ----------------------------------------------------------

def test_cnn_serve_cli_with_chaos_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--cnn-serve",
         "--chaos", "--cnn", "resnet50", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "slo ok" in out.stdout
    assert "chaos:" in out.stdout
