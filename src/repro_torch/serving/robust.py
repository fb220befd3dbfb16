"""Fault-tolerant shape-bucketed CNN serving tier over ``CnnEngine``.

Port of ``repro/serving/robust.py``.  The conv kernels make sparse conv
fast; telemetry and the pre-flight verifier make "the fast path is
unavailable" an observable, classifiable state for a single forward.  This
module lifts that discipline to the request-serving layer, where Escoin's
premise — sparse execution wins only under the right conditions — meets
heavy traffic:

  admission control      requests are routed to *shape buckets* (a fixed
                         (c, h, w, batch) each, padded up, one engine a
                         bucket whose banks are built once per rung);
                         bounded per-bucket queues shed load with
                         machine-readable rejection reasons; per-request
                         deadlines shed work that could no longer be useful
  retry with backoff     a failing serve step is classified by the
                         *production* ``FailureDetector`` (shared with the
                         training loop): retryable faults re-enqueue their
                         requests under a deterministic capped-exponential
                         ``Backoff``; fatal faults reject with a reason;
                         repeated retryables escalate into degradation
  graceful degradation   each bucket owns an explicit plan ladder —
                         ``tuned`` (the autotuner's plan) -> ``quantised``
                         (the same plan with int8 value streams) ->
                         ``dense`` (the always-feasible baseline).  Every
                         rung is verified by the pre-flight checker at
                         build time, against the engine's device: a rung
                         whose plan the card's kernels cannot run, or that
                         would fall back, is *dropped*, not served; under
                         overload or
                         escalating faults the bucket steps down a rung,
                         and steps back up after a cool-down of healthy
                         ticks.  The executed rung is recorded on every
                         forward's ``ExecutionReport`` and in telemetry.

Nothing here blocks on lost work: every submitted request terminates in
exactly one of completed-with-result or rejected-with-reason — the
invariant the seeded chaos harness (``serving.chaos``) asserts under
injected plan corruption, schedule infeasibility, step faults, and
straggler ticks.

A serve step runs the batch on the bucket's device (``device=``, default
the card) and copies the result to the host inside its ``try``: CUDA
errors surface at that synchronisation, so the production detector
classifies them, and a wall-clock tick measures the device's work, not
just the launches.

Time is injectable: ``VirtualClock`` drives deadlines, backoff, and
latency bookkeeping from the roofline cost of the executed rung (plus any
chaos inflation), so SLO tests are bit-deterministic; the port's roofline
prices the card (``launch/roofline.py``), so the same trace gives other
latencies than the reference's unless ``min_tick_s`` lies above both.
``WallClock`` serves real time, from the start of a trace: arrival times
are offsets from the clock's reading when ``run_trace`` starts (on a fresh
``VirtualClock``, 0, as on the reference; the reference's wall clock would
submit a whole trace at once).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.engine import CnnEngine, NoKernelSchedule, Program, lower
from repro_torch.runtime.fault_tolerance import (Backoff, FailureDetector,
                                                 StragglerMonitor)
from repro_torch.serving.chaos import ChaosInjector
from repro_torch.tuning.cache import PlanCache, PlanEntry
from repro_torch.tuning.planner import backend_of

# Machine-readable rejection reasons — every rejected request carries
# exactly one, and telemetry counts each under
# ``serving.cnn.rejected.<reason>``.
REJECT_REASONS = frozenset({
    "no_bucket",          # no configured bucket fits the request's shape
    "queue_full",         # bounded bucket queue at capacity (load shed)
    "deadline_expired",   # end-to-end deadline passed while queued
    "retries_exhausted",  # retryable faults exceeded max_attempts
    "fatal_error",        # serve step raised a non-retryable failure
    "drain_exhausted",    # server stopped (tick budget) before dispatch
})

# Ladder step reasons recorded on degradation/recovery events.
LADDER_REASONS = frozenset({
    "overload",          # queue above the high-water mark
    "escalate",          # FailureDetector strikes exhausted
    "preflight_failed",  # rung dropped at build: verifier errors/fallbacks
    "recovered",         # cool-down of healthy ticks passed: step back up
})


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One admission bucket: requests of channel count ``c`` with spatial
    extent <= (h, w) are zero-padded up to exactly this shape and served
    in fixed batches of ``batch``."""

    c: int
    h: int
    w: int
    batch: int = 4

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.c, self.h, self.w)

    @property
    def key(self) -> str:
        return f"{self.c}x{self.h}x{self.w}b{self.batch}"


@dataclasses.dataclass
class InferenceRequest:
    """One CNN inference request.

    ``x`` is the input image (c, h, w); ``None`` serves zeros of ``shape``
    (synthetic traces).  ``deadline_s`` is the end-to-end budget relative
    to submission; expired requests are shed, not served late silently.
    """

    rid: int
    x: Optional[np.ndarray] = None
    shape: Optional[Tuple[int, int, int]] = None
    deadline_s: Optional[float] = None
    # filled by the server
    status: str = "new"            # new | queued | done | rejected
    reject_reason: Optional[str] = None
    attempts: int = 0              # serve attempts consumed so far
    submitted_s: float = 0.0
    not_before_s: float = 0.0      # backoff: earliest re-dispatch time
    deadline_abs_s: Optional[float] = None
    completed_s: Optional[float] = None
    result: Optional[np.ndarray] = None
    rung: Optional[str] = None     # ladder rung the result was computed at
    bucket: Optional[str] = None

    def __post_init__(self):
        if self.shape is None:
            if self.x is None:
                raise ValueError("request needs x or shape")
            self.shape = tuple(self.x.shape)

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_s is None:
            return None
        return self.completed_s - self.submitted_s


@dataclasses.dataclass(frozen=True)
class LadderEvent:
    """One degradation-ladder transition (or build-time rung drop)."""

    t_s: float
    bucket: str
    from_rung: str
    to_rung: str
    reason: str                    # one of LADDER_REASONS

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class VirtualClock:
    """Deterministic clock: ticks advance by the executed rung's roofline
    cost (plus chaos inflation) instead of host wall time."""

    virtual = True

    def __init__(self, start_s: float = 0.0):
        self._t = start_s

    def now(self) -> float:
        return self._t

    def advance(self, dt_s: float) -> None:
        self._t += max(dt_s, 0.0)


class WallClock:
    """Real time (``time.perf_counter``).  ``advance`` sleeps (bounded) so
    idle waits make progress toward arrivals/backoff expiries without
    spinning."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt_s: float) -> None:
        if dt_s > 0:
            time.sleep(min(dt_s, 0.005))


@dataclasses.dataclass
class _Rung:
    """One verified rung of a bucket's degradation ladder."""

    name: str                       # tuned | quantised | dense
    plan: Dict[str, PlanEntry]
    report: Any                     # static ExecutionReport at this rung
    est_s: float                    # roofline batch-forward estimate


@dataclasses.dataclass
class _Bucket:
    spec: BucketSpec
    program: Program
    engine: CnnEngine
    rungs: List[_Rung]
    detector: FailureDetector
    rung_idx: int = 0
    healthy_ticks: int = 0
    queue: Deque[InferenceRequest] = dataclasses.field(
        default_factory=collections.deque)

    @property
    def rung(self) -> _Rung:
        return self.rungs[self.rung_idx]


@dataclasses.dataclass
class SloReport:
    """End-of-trace SLO summary: the robustness acceptance surface."""

    submitted: int = 0
    completed: int = 0
    rejected: Dict[str, int] = dataclasses.field(default_factory=dict)
    retries: int = 0
    deadline_misses: int = 0        # completed, but after their deadline
    straggler_ticks: int = 0
    ticks: int = 0
    p50_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    max_latency_s: float = 0.0
    degradations: List[LadderEvent] = dataclasses.field(default_factory=list)
    dropped_rungs: List[dict] = dataclasses.field(default_factory=list)
    rungs_executed: Dict[str, int] = dataclasses.field(default_factory=dict)
    duplicated: int = 0

    @property
    def rejected_total(self) -> int:
        return sum(self.rejected.values())

    @property
    def lost(self) -> int:
        return self.submitted - self.completed - self.rejected_total

    def verify(self) -> "SloReport":
        """Raise unless every request terminated exactly once."""
        if self.lost:
            raise AssertionError(
                f"{self.lost} request(s) lost: submitted={self.submitted} "
                f"completed={self.completed} rejected={self.rejected}")
        if self.duplicated:
            raise AssertionError(
                f"{self.duplicated} request(s) terminated more than once")
        return self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["degradations"] = [e.to_dict() for e in self.degradations]
        d["rejected_total"] = self.rejected_total
        d["lost"] = self.lost
        return d

    def format(self) -> str:
        rej = ", ".join(f"{k}={v}" for k, v in sorted(self.rejected.items()))
        lines = [
            f"SLO: submitted={self.submitted} completed={self.completed} "
            f"rejected={self.rejected_total} ({rej or 'none'}) "
            f"lost={self.lost}",
            f"     retries={self.retries} deadline_misses="
            f"{self.deadline_misses} straggler_ticks={self.straggler_ticks} "
            f"ticks={self.ticks}",
            f"     latency p50={self.p50_latency_s * 1e3:.3f}ms "
            f"p99={self.p99_latency_s * 1e3:.3f}ms "
            f"max={self.max_latency_s * 1e3:.3f}ms",
            f"     rungs_executed={self.rungs_executed or '{}'} "
            f"degradations={len(self.degradations)} "
            f"dropped_rungs={len(self.dropped_rungs)}",
        ]
        for e in self.degradations:
            lines.append(f"     ladder t={e.t_s * 1e3:9.3f}ms {e.bucket}: "
                         f"{e.from_rung} -> {e.to_rung} ({e.reason})")
        return "\n".join(lines)


class RobustCnnServer:
    """Shape-bucketed, deadline-aware, degradation-laddered CNN serving.

    ``net`` is a layer-spec list (``repro_torch.models.cnn`` vocabulary)
    and ``params`` its conv parameters on ``device`` (shared across buckets
    — conv weights are spatial-size-independent).  One engine on
    ``device`` + plan ladder is built per ``BucketSpec``; ``plan``
    optionally overrides the autotuner (a ``{layer: PlanEntry}`` dict
    applied to every bucket, or a callable
    ``(program, batch) -> plan``), and ``plan_cache`` names a persistent
    plan-cache JSON consulted when autotuning (the chaos harness corrupts
    this file to exercise resilient loading).

    ``chaos`` (a :class:`~repro_torch.serving.chaos.ChaosInjector`) injects
    faults at the documented seams; production deployments leave it None.
    """

    def __init__(self, net: Sequence[Any], params: Dict[str, Any],
                 buckets: Sequence[BucketSpec], *,
                 plan: Any = None,
                 plan_cache: Optional[str] = None,
                 queue_depth: int = 64,
                 max_attempts: int = 3,
                 backoff: Optional[Backoff] = None,
                 default_deadline_s: Optional[float] = None,
                 high_water: float = 0.75,
                 low_water: float = 0.25,
                 cooldown_ticks: int = 8,
                 max_strikes: int = 3,
                 min_tick_s: float = 1e-6,
                 clock: Any = None,
                 monitor: Optional[StragglerMonitor] = None,
                 chaos: Optional[ChaosInjector] = None,
                 device="cuda"):
        if not buckets:
            raise ValueError("need at least one BucketSpec")
        if not 0.0 <= low_water <= high_water <= 1.0:
            raise ValueError(
                f"water marks must satisfy 0 <= low ({low_water}) <= "
                f"high ({high_water}) <= 1")
        self.params = params
        self.device = resolve_device(device)
        self.queue_depth = queue_depth
        self.max_attempts = max_attempts
        self.backoff = backoff or Backoff()
        self.default_deadline_s = default_deadline_s
        self.high_water = high_water
        self.low_water = low_water
        self.cooldown_ticks = cooldown_ticks
        self.min_tick_s = min_tick_s
        self.clock = clock if clock is not None else WallClock()
        self.monitor = monitor or StragglerMonitor()
        self.chaos = chaos
        self.events: List[LadderEvent] = []
        self.dropped_rungs: List[dict] = []
        self.requests: List[InferenceRequest] = []
        self._terminal: Dict[int, int] = {}   # rid -> terminal transitions
        self._rungs_executed: Dict[str, int] = {}
        self._retries = 0
        self._straggler_ticks = 0
        self._ticks = 0
        self._buckets = [
            self._build_bucket(net, spec, plan, plan_cache, max_strikes)
            for spec in buckets]

    # -- construction ------------------------------------------------------

    def _build_bucket(self, net, spec: BucketSpec, plan,
                      plan_cache: Optional[str],
                      max_strikes: int) -> _Bucket:
        program = lower(net, spec.shape)
        if callable(plan):
            base = plan(program, spec.batch)
        elif plan is not None:
            base = dict(plan)
        else:
            from repro_torch.tuning.planner import plan_program
            cache = PlanCache(plan_cache) if plan_cache else None
            base = plan_program(program, batch=spec.batch, mode="roofline",
                                cache=cache, params=self.params,
                                device=self.device)
        if self.chaos is not None:
            # Forced-schedule-infeasibility seam: the injector stales some
            # entries; the ladder build below must catch them statically.
            base = self.chaos.corrupt_plan(base, program)
        engine = CnnEngine(program, self.params, None, device=self.device)
        rungs = self._build_ladder(spec, program, engine, base)
        return _Bucket(spec=spec, program=program, engine=engine,
                       rungs=rungs,
                       detector=FailureDetector(max_strikes=max_strikes))

    def _ladder_plans(self, base: Dict[str, PlanEntry],
                      ) -> List[Tuple[str, Dict[str, PlanEntry]]]:
        """The rung candidates derived from one tuned plan: tuned ->
        quantised (int8 value streams on the sparse kernels — the engine
        quantises f32 banks in-trace) -> dense (always feasible)."""
        quant = {
            name: (dataclasses.replace(pe, value_dtype="int8",
                                       provenance="ladder")
                   if pe.method in ("pallas", "bsr")
                   and pe.value_dtype == "float32" else pe)
            for name, pe in base.items()}
        dense = {name: PlanEntry(method="dense", source=pe.source,
                                 provenance="ladder")
                 for name, pe in base.items()}
        out = [("tuned", base)]
        if quant != base:
            out.append(("quantised", quant))
        if dense != base:
            out.append(("dense", dense))
        return out

    def _build_ladder(self, spec: BucketSpec, program: Program,
                      engine: CnnEngine,
                      base: Dict[str, PlanEntry]) -> List[_Rung]:
        """Verify each candidate rung with the pre-flight checker (against
        the engine's device) and the engine's static dispatch report; a
        rung that would error or silently fall back is dropped (recorded),
        never served.  A rung preflight passes but the engine's dispatch
        refuses is a verifier fault: the refusal propagates."""
        from repro_torch.analysis.checker import preflight

        shape = (spec.batch,) + spec.shape
        backend = backend_of(engine.device)
        rungs: List[_Rung] = []
        for name, plan in self._ladder_plans(base):
            diags = preflight(program, plan, self.params, batch=spec.batch,
                              backend=backend)
            errors = [d for d in diags if d.severity == "error"]
            try:
                report = engine.execution_report(
                    shape, "auto", plan_override=plan, rung=name)
                reasons = [o.fallback_reason for o in report.fallback_ops]
            except NoKernelSchedule as exc:
                if not errors:
                    raise
                # the card refuses what the reference would fall back on
                report, reasons = None, [why for _, why in exc.refused]
            if errors or reasons:
                drop = {
                    "bucket": spec.key, "rung": name,
                    "preflight_errors": [d.rule for d in errors],
                    "fallback_reasons": reasons,
                }
                self.dropped_rungs.append(drop)
                if telemetry.is_enabled():
                    telemetry.counter("serving.cnn.ladder.dropped_rungs").inc()
                continue
            rungs.append(_Rung(name=name, plan=plan, report=report,
                               est_s=max(report.est_s, self.min_tick_s)))
        if not rungs:
            # The dense rung is feasibility-free; reaching here means the
            # program itself fails verification — a config bug, not a
            # runtime state to degrade through.
            raise RuntimeError(
                f"bucket {spec.key}: no ladder rung passed pre-flight "
                f"verification ({self.dropped_rungs})")
        return rungs

    # -- admission ---------------------------------------------------------

    def _bucket_for(self, shape: Tuple[int, int, int]) -> Optional[_Bucket]:
        c, h, w = shape
        fits = [b for b in self._buckets
                if b.spec.c == c and b.spec.h >= h and b.spec.w >= w]
        if not fits:
            return None
        return min(fits, key=lambda b: b.spec.h * b.spec.w)

    def submit(self, req: InferenceRequest) -> bool:
        """Admit one request; returns False when it was rejected (shed) at
        admission — the request still terminates with a reason."""
        now = self.clock.now()
        req.submitted_s = now
        req.not_before_s = now
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        if req.deadline_s is not None:
            req.deadline_abs_s = now + req.deadline_s
        self.requests.append(req)
        if telemetry.is_enabled():
            telemetry.counter("serving.cnn.submitted").inc()
        bucket = self._bucket_for(req.shape)
        if bucket is None:
            self._reject(req, "no_bucket")
            return False
        if len(bucket.queue) >= self.queue_depth:
            self._reject(req, "queue_full")
            return False
        req.status = "queued"
        req.bucket = bucket.spec.key
        bucket.queue.append(req)
        if telemetry.is_enabled():
            telemetry.counter("serving.cnn.admitted").inc()
            telemetry.gauge(
                f"serving.cnn.queue_depth.{bucket.spec.key}").set(
                    len(bucket.queue))
        return True

    # -- terminal transitions ---------------------------------------------

    def _terminate(self, req: InferenceRequest) -> None:
        self._terminal[req.rid] = self._terminal.get(req.rid, 0) + 1

    def _reject(self, req: InferenceRequest, reason: str) -> None:
        if reason not in REJECT_REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}")
        req.status = "rejected"
        req.reject_reason = reason
        self._terminate(req)
        if telemetry.is_enabled():
            telemetry.counter("serving.cnn.rejected").inc()
            telemetry.counter(f"serving.cnn.rejected.{reason}").inc()

    def _complete(self, req: InferenceRequest, y: np.ndarray,
                  rung: str) -> None:
        now = self.clock.now()
        req.status = "done"
        req.result = y
        req.rung = rung
        req.completed_s = now
        self._terminate(req)
        if telemetry.is_enabled():
            telemetry.counter("serving.cnn.completed").inc()
            telemetry.histogram("serving.cnn.latency_s").observe(
                req.latency_s)

    # -- the degradation ladder -------------------------------------------

    def _step_down(self, bucket: _Bucket, reason: str) -> bool:
        if bucket.rung_idx >= len(bucket.rungs) - 1:
            return False
        frm = bucket.rung.name
        bucket.rung_idx += 1
        bucket.healthy_ticks = 0
        self._ladder_event(bucket, frm, bucket.rung.name, reason)
        if telemetry.is_enabled():
            telemetry.counter("serving.cnn.ladder.step_down").inc()
        return True

    def _step_up(self, bucket: _Bucket) -> bool:
        if bucket.rung_idx == 0:
            return False
        frm = bucket.rung.name
        bucket.rung_idx -= 1
        bucket.healthy_ticks = 0
        self._ladder_event(bucket, frm, bucket.rung.name, "recovered")
        if telemetry.is_enabled():
            telemetry.counter("serving.cnn.ladder.step_up").inc()
        return True

    def _ladder_event(self, bucket: _Bucket, frm: str, to: str,
                      reason: str) -> None:
        if reason not in LADDER_REASONS:
            raise ValueError(f"unknown ladder reason {reason!r}")
        self.events.append(LadderEvent(
            t_s=self.clock.now(), bucket=bucket.spec.key, from_rung=frm,
            to_rung=to, reason=reason))
        if telemetry.is_enabled():
            telemetry.gauge(f"serving.cnn.rung.{bucket.spec.key}").set(
                bucket.rung_idx)

    # -- the serve loop ----------------------------------------------------

    def _shed_expired(self, bucket: _Bucket) -> None:
        now = self.clock.now()
        keep: Deque[InferenceRequest] = collections.deque()
        for req in bucket.queue:
            if req.deadline_abs_s is not None and now >= req.deadline_abs_s:
                self._reject(req, "deadline_expired")
            else:
                keep.append(req)
        bucket.queue = keep

    def _eligible(self, bucket: _Bucket) -> List[InferenceRequest]:
        """Up to ``batch`` queued requests whose backoff has expired,
        FIFO order preserved for the rest."""
        now = self.clock.now()
        take: List[InferenceRequest] = []
        keep: Deque[InferenceRequest] = collections.deque()
        for req in bucket.queue:
            if len(take) < bucket.spec.batch and req.not_before_s <= now:
                take.append(req)
            else:
                keep.append(req)
        bucket.queue = keep
        return take

    def _batch_input(self, bucket: _Bucket,
                     reqs: List[InferenceRequest]) -> torch.Tensor:
        """One host batch, padded up into the bucket shape, moved to the
        device once."""
        spec = bucket.spec
        x = np.zeros((spec.batch,) + spec.shape, np.float32)
        for i, req in enumerate(reqs):
            if req.x is not None:
                c, h, w = req.x.shape
                x[i, :c, :h, :w] = req.x  # pad up into the bucket shape
        return torch.from_numpy(x).to(self.device)

    def _dispatch(self, bucket: _Bucket,
                  reqs: List[InferenceRequest]) -> None:
        """One serve step: run the batch at the bucket's current rung and
        copy the result to the host (the synchronisation at which a CUDA
        fault surfaces); classify any failure through the production
        detector."""
        rung = bucket.rung
        try:
            if self.chaos is not None:
                exc = self.chaos.draw_step_fault()
                if exc is not None:
                    raise exc
            y = bucket.engine(
                self._batch_input(bucket, reqs), "auto",
                plan_override=rung.plan, rung=rung.name).cpu().numpy()
        except Exception as exc:  # noqa: BLE001 - classified below
            self._on_step_failure(bucket, reqs, exc)
            return
        bucket.detector.reset()
        for i, req in enumerate(reqs):
            self._complete(req, y[i], rung.name)
        self._rungs_executed[rung.name] = (
            self._rungs_executed.get(rung.name, 0) + 1)
        if telemetry.is_enabled():
            telemetry.counter(f"serving.cnn.rung_ticks.{rung.name}").inc()

    def _on_step_failure(self, bucket: _Bucket,
                         reqs: List[InferenceRequest],
                         exc: BaseException) -> None:
        verdict = bucket.detector.record(exc)
        if verdict == "fatal":
            for req in reqs:
                self._reject(req, "fatal_error")
            return
        if verdict == "escalate":
            # Repeated retryable faults: the rung is suspect — degrade and
            # give the batch a fresh start on the next rung down.
            self._step_down(bucket, "escalate")
            bucket.detector.reset()
        now = self.clock.now()
        for req in reqs:
            req.attempts += 1
            if req.attempts >= self.max_attempts:
                self._reject(req, "retries_exhausted")
                continue
            req.not_before_s = now + self.backoff.delay_s(req.attempts - 1)
            bucket.queue.appendleft(req)
            self._retries += 1
            if telemetry.is_enabled():
                telemetry.counter("serving.cnn.retries").inc()

    def tick(self) -> int:
        """One scheduling round over every bucket; returns the number of
        requests dispatched (0: nothing was eligible)."""
        dispatched = 0
        telem = telemetry.is_enabled()
        for bucket in self._buckets:
            self._shed_expired(bucket)
            if (len(bucket.queue) >= self.high_water * self.queue_depth
                    and bucket.queue):
                self._step_down(bucket, "overload")
            reqs = self._eligible(bucket)
            if telem:
                telemetry.gauge(
                    f"serving.cnn.queue_depth.{bucket.spec.key}").set(
                        len(bucket.queue) + len(reqs))
            if not reqs:
                continue
            # Tick duration: roofline cost of the dispatched rung under a
            # virtual clock (deterministic), measured wall otherwise —
            # either way subject to chaos straggler inflation and observed
            # by the EWMA monitor.  The straggle draw happens before the
            # dispatch, and a virtual clock advances past the batch cost
            # before completion bookkeeping, so request latencies include
            # (possibly inflated) execution time deterministically.
            t0 = time.perf_counter()
            dt = bucket.rung.est_s
            straggled = False
            if self.chaos is not None:
                dt, straggled = self.chaos.inflate_tick(dt)
            if self.clock.virtual:
                self.clock.advance(dt)
            self._dispatch(bucket, reqs)
            dispatched += len(reqs)
            self._ticks += 1
            if not self.clock.virtual:
                dt = time.perf_counter() - t0
                if straggled:
                    dt *= self.chaos.cfg.straggler_factor
                    time.sleep(min(dt, 0.01))
            if self.monitor.observe(dt):
                self._straggler_ticks += 1
                if telem:
                    telemetry.counter("serving.cnn.straggler_ticks").inc()
            if telem:
                telemetry.gauge("serving.cnn.tick_ewma_s").set(
                    self.monitor.mean)
                telemetry.histogram("serving.cnn.tick_latency_s").observe(dt)
            # Recovery bookkeeping: a dispatched tick with no strikes and a
            # calm queue is healthy; enough of them steps the ladder up.
            if (bucket.detector.strikes == 0
                    and len(bucket.queue) <= self.low_water
                    * self.queue_depth):
                bucket.healthy_ticks += 1
                if (bucket.healthy_ticks >= self.cooldown_ticks
                        and bucket.rung_idx > 0):
                    self._step_up(bucket)
            else:
                bucket.healthy_ticks = 0
        return dispatched

    # -- traces ------------------------------------------------------------

    def pending(self) -> int:
        return sum(len(b.queue) for b in self._buckets)

    def run_trace(self, arrivals: Sequence[Any], *,
                  request_factory: Optional[Callable[[Any], InferenceRequest]]
                  = None, max_ticks: int = 100_000) -> SloReport:
        """Serve a seeded arrival trace (``repro_torch.serving.chaos
        .arrival_trace``) to completion and return the SLO summary.

        Arrivals are submitted when the clock reaches their ``t_s``, an
        offset from the clock's reading when the trace starts; idle
        rounds advance a virtual clock to the next actionable instant
        (arrival or backoff expiry) instead of spinning.  Requests still
        queued when the tick budget runs out are rejected with
        ``drain_exhausted`` — stopping the server must not lose requests.
        """
        make = request_factory or (lambda a: InferenceRequest(
            rid=a.rid, shape=a.shape, deadline_s=a.deadline_s))
        todo = sorted(arrivals, key=lambda a: a.t_s)
        t0 = self.clock.now()
        i = 0
        ticks = 0
        while ticks < max_ticks:
            now = self.clock.now()
            while i < len(todo) and t0 + todo[i].t_s <= now:
                self.submit(make(todo[i]))
                i += 1
            if i == len(todo) and self.pending() == 0:
                break
            n = self.tick()
            ticks += 1
            if n == 0:
                # Nothing eligible: jump to the next actionable instant.
                horizon = [t0 + a.t_s for a in todo[i:i + 1]]
                horizon += [r.not_before_s
                            for b in self._buckets for r in b.queue]
                if not horizon:
                    break
                self.clock.advance(max(min(horizon) - now, self.min_tick_s))
        for bucket in self._buckets:
            while bucket.queue:
                self._reject(bucket.queue.popleft(), "drain_exhausted")
        return self.slo_report()

    def slo_report(self) -> SloReport:
        rep = SloReport()
        rep.submitted = len(self.requests)
        lat: List[float] = []
        for req in self.requests:
            if req.status == "done":
                rep.completed += 1
                lat.append(req.latency_s)
                if (req.deadline_abs_s is not None
                        and req.completed_s > req.deadline_abs_s):
                    rep.deadline_misses += 1
            elif req.status == "rejected":
                rep.rejected[req.reject_reason] = (
                    rep.rejected.get(req.reject_reason, 0) + 1)
        rep.retries = self._retries
        rep.straggler_ticks = self._straggler_ticks
        rep.ticks = self._ticks
        rep.degradations = list(self.events)
        rep.dropped_rungs = list(self.dropped_rungs)
        rep.rungs_executed = dict(self._rungs_executed)
        rep.duplicated = sum(1 for n in self._terminal.values() if n > 1)
        if lat:
            xs = sorted(lat)
            rep.p50_latency_s = xs[min(len(xs) - 1, int(0.50 * len(xs)))]
            rep.p99_latency_s = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
            rep.max_latency_s = xs[-1]
        return rep
