"""Deterministic, seeded fault injection for the CNN serving tier.

Port of ``repro/serving/chaos.py``: the same seed gives the same draws, in
the same order, as the reference (one numpy Generator), so a chaos run of
the port replays the reference's fault sequence tick for tick.

Production robustness claims ("zero lost requests under faults", "the
degradation ladder activates and recovers", "p99 stays bounded") are only
testable if faults are *reproducible*.  This module injects failures at the
seams the execution stack already treats as first-class states — never by
monkeypatching internals — so every chaos run is an ordinary run of
production code under adverse, replayable inputs:

  plan-cache corruption      ``corrupt_plan_cache_file`` mangles the JSON
                             document on disk; ``PlanCache.load``
                             degrades to an empty cache with a
                             ``PlanCacheWarning`` and the planner re-tunes
  forced schedule            ``ChaosInjector.corrupt_plan`` pins
  infeasibility              ``tm = m - 1`` on pallas entries, as the
                             reference does: on the card a channel tile
                             the ELL kernel does not instantiate
                             (``unsupported_tm``; no layer of the three
                             nets has ``m - 1`` in ``budget.ELL_TILES``),
                             which the kernel's ``resolve_schedule`` probe
                             and the pre-flight verifier both classify;
                             the serving ladder drops the rung instead of
                             serving a plan whose forward would raise.
                             ``bsr`` entries are left alone, as there
  serve-step faults          ``draw_step_fault`` raises retryable
                             (``ChaosRetryableError`` — message carries a
                             ``RETRYABLE_MARKERS`` token so the *production*
                             ``FailureDetector`` classifies it) or fatal
                             (``ChaosFatalError``) exceptions inside the
                             serve step
  straggler ticks            ``inflate_tick`` multiplies a tick's duration
                             so ``StragglerMonitor`` flags it (virtual-clock
                             runs stay fully deterministic; wall-clock runs
                             sleep the excess)

All draws come from one ``numpy`` Generator seeded by ``ChaosConfig.seed``:
the same config and workload replay the same fault sequence, tick for tick.

The module also hosts the synthetic-workload helpers shared by the tests,
the serving CLI and ``chip_smoke.py``: ``slice_net`` (a reduced 3-conv
slice of each paper network, small enough for the plain versions on the
CPU) and ``arrival_trace`` (a seeded heavy-traffic arrival process).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

# Retryable messages must trip runtime.fault_tolerance.RETRYABLE_MARKERS
# ("UNAVAILABLE") — chaos faults are classified by the production detector,
# not by a chaos-aware special case.
_RETRYABLE_MSG = "UNAVAILABLE: injected transient collective fault (chaos)"
_FATAL_MSG = "injected device loss (chaos): host dropped from the mesh"


class ChaosRetryableError(RuntimeError):
    """An injected transient fault (classified retryable by message)."""


class ChaosFatalError(RuntimeError):
    """An injected hard failure (classified fatal: no retryable marker)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Injection rates (per opportunity) + the seed that makes them replay.

    Rates are independent Bernoulli draws: ``step_fault_rate`` /
    ``fatal_fault_rate`` per dispatched batch (retryable is drawn first),
    ``plan_corruption_rate`` per tuned pallas plan entry,
    ``straggler_rate`` per tick.  ``straggler_factor`` multiplies a
    straggling tick's duration.
    """

    seed: int = 0
    step_fault_rate: float = 0.0
    fatal_fault_rate: float = 0.0
    plan_corruption_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_factor: float = 8.0

    def __post_init__(self):
        for f in ("step_fault_rate", "fatal_fault_rate",
                  "plan_corruption_rate", "straggler_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} outside [0, 1]")
        if self.straggler_factor < 1.0:
            raise ValueError(
                f"straggler_factor={self.straggler_factor} below 1")


class ChaosInjector:
    """Draws faults from one seeded stream at the serving tier's seams."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.injected_step_faults = 0
        self.injected_fatal_faults = 0
        self.injected_stragglers = 0
        self.corrupted_entries: List[str] = []

    # -- serve-step faults -------------------------------------------------

    def draw_step_fault(self) -> Optional[Exception]:
        """One per-batch draw: a retryable or fatal exception, or None.

        The caller raises the returned exception *inside* its serve step so
        the production retry/rejection machinery handles it.
        """
        if (self.cfg.step_fault_rate
                and self.rng.random() < self.cfg.step_fault_rate):
            self.injected_step_faults += 1
            return ChaosRetryableError(_RETRYABLE_MSG)
        if (self.cfg.fatal_fault_rate
                and self.rng.random() < self.cfg.fatal_fault_rate):
            self.injected_fatal_faults += 1
            return ChaosFatalError(_FATAL_MSG)
        return None

    # -- straggler ticks ---------------------------------------------------

    def inflate_tick(self, dt: float) -> Tuple[float, bool]:
        """Maybe stretch one tick's duration; returns (dt', straggled)."""
        if (self.cfg.straggler_rate
                and self.rng.random() < self.cfg.straggler_rate):
            self.injected_stragglers += 1
            return dt * self.cfg.straggler_factor, True
        return dt, False

    # -- forced schedule infeasibility ------------------------------------

    def corrupt_plan(self, plan, program):
        """Pin ``tm = m - 1`` on pallas entries at the configured rate: a
        stale plan the card's ``resolve_schedule`` reports as
        ``unsupported_tm`` (the reference's ``nondividing_tm``) and the
        pre-flight verifier flags as an error.

        ``m - 1`` never divides ``m`` for ``m > 2`` (layers with ``m <= 2``
        are skipped) and is not one of the ELL kernel's tiles for any layer
        of the three nets, so the corruption is infeasible on both.
        Returns a new plan dict; the input is not mutated.
        """
        out = dict(plan)
        for op in program.conv_ops:
            pe = out.get(op.name)
            if (pe is None or pe.method != "pallas" or op.m <= 2
                    or not self.cfg.plan_corruption_rate):
                continue
            if self.rng.random() < self.cfg.plan_corruption_rate:
                out[op.name] = dataclasses.replace(pe, tm=op.m - 1)
                self.corrupted_entries.append(op.name)
        return out

    def summary(self) -> dict:
        return {"seed": self.cfg.seed,
                "step_faults": self.injected_step_faults,
                "fatal_faults": self.injected_fatal_faults,
                "stragglers": self.injected_stragglers,
                "corrupted_entries": list(self.corrupted_entries)}


def corrupt_plan_cache_file(path: str, *, mode: str = "garbage") -> None:
    """Mangle a plan-cache document on disk (the plan-load seam).

    ``garbage`` overwrites with non-JSON bytes, ``truncate`` cuts the file
    mid-document, ``bad_entry`` drops a required field from one entry —
    each a corruption ``PlanCache.load`` must degrade through (empty or
    reduced cache + ``PlanCacheWarning``), never crash on.
    """
    if mode == "garbage":
        with open(path, "w") as fh:
            fh.write("\x00not json {{{")
        return
    with open(path) as fh:
        text = fh.read()
    if mode == "truncate":
        with open(path, "w") as fh:
            fh.write(text[: max(1, len(text) // 2)])
        return
    if mode == "bad_entry":
        doc = json.loads(text)
        for key, entry in doc.get("entries", {}).items():
            entry.pop("method", None)
            break
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return
    raise ValueError(f"unknown corruption mode {mode!r}")


# --------------------------------------------------------------------------
# synthetic workloads (shared by tests, CI chaos-smoke, and the benchmark)
# --------------------------------------------------------------------------

def slice_net(name: str, *, image: int = 12) -> List[Any]:
    """A reduced slice of one paper network: the first dense-kept conv plus
    the first two sparse convs, channels cut ~8x, stride forced to 1 — the
    same reduction ``launch/serve.py``'s autotune numeric check uses, so
    the plain versions serve it tractably on the CPU.  ``image`` is the
    native input the slice is sized for (buckets may pad above it)."""
    from repro_torch.engine import lower
    from repro_torch.models import cnn

    program = lower(cnn.NETWORKS[name](), (3, 224, 224))
    convs = [l for l, _ in program.conv_table]
    picked = ([next(l for l in convs if l.sparsity == 0)]
              + [l for l in convs if l.sparsity > 0][:2])
    net: List[Any] = []
    for l in picked:
        net.append(dataclasses.replace(
            l, out_c=max(8, min(32, l.out_c // 8)), stride=1))
        net.append(cnn.Relu())
    return net


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One synthetic request arrival."""

    rid: int
    t_s: float                 # arrival time (seconds from trace start)
    shape: Tuple[int, int, int]  # (c, h, w)
    deadline_s: Optional[float]  # end-to-end budget from arrival, or None


def arrival_trace(n: int, shapes: Sequence[Tuple[int, int, int]], *,
                  seed: int = 0, mean_gap_s: float = 0.002,
                  deadline_s: Optional[Tuple[float, float]] = (0.05, 0.5),
                  ) -> List[Arrival]:
    """A seeded heavy-traffic trace: exponential inter-arrivals
    (``mean_gap_s``), shapes drawn uniformly from ``shapes``, per-request
    deadlines uniform in ``deadline_s`` (None: no deadlines)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Arrival] = []
    for rid in range(n):
        t += float(rng.exponential(mean_gap_s))
        shape = shapes[int(rng.integers(len(shapes)))]
        dl = (float(rng.uniform(*deadline_s))
              if deadline_s is not None else None)
        out.append(Arrival(rid=rid, t_s=t, shape=tuple(shape), deadline_s=dl))
    return out
