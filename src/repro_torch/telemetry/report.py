"""Per-forward execution reports: what actually ran, and why.

Port of ``repro/telemetry/report.py``, field for field.

An :class:`ExecutionReport` is the engine's per-forward answer to "which
kernel did each conv layer execute, where did its plan come from, and did
anything silently fall back?" — the per-layer attribution the Escoin paper
argues from, produced by ``CnnEngine`` at dispatch time (the dispatch
decisions are static Python over shapes and plan entries, so building the
report launches nothing).

Per :class:`OpReport` fields:

  method_planned / method_executed
      the method the plan (or the caller) asked for vs the one the resolved
      schedule actually runs — they differ exactly when a fallback fired
  fallback_reason
      a machine-readable code from ``repro_torch.telemetry.fallback.REASONS``
      (None on the healthy path)
  provenance
      where the plan entry came from: ``cache_hit`` (persistent plan
      cache, current schema), ``migrated`` (loaded via a v1-v4 schema
      migration or inherited from a legacy un-tagged key),
      ``freshly_tuned`` (scored this run), ``default`` (dense-kept layer
      or no plan entry), ``direct`` (caller forced the method, no plan
      consulted)
  flops / hbm_bytes / staging_stall_s / est_s
      roofline-attributed cost of the *executed* schedule (the
      ``repro_torch.tuning.measure`` cost model over ``launch/roofline.py``
      constants)
  wall_s
      measured wall seconds, filled only by the engine's opt-in timed mode
      (``CnnEngine.forward_timed`` — each op between two CUDA events on
      the card, or the host clock on the CPU)

The report-level ``rung`` field names the degradation-ladder rung the
serving tier executed this forward at (``tuned`` / ``quantised`` /
``dense`` — see the serving tier); ``None`` for forwards outside
the ladder (direct engine calls).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.telemetry.trace import TID_ROOFLINE, Tracer


@dataclasses.dataclass
class OpReport:
    """Execution record for one conv op of one forward."""

    name: str
    method_planned: str
    method_executed: str
    provenance: str = "default"
    plan_source: str = "-"               # PlanEntry.source, "-" without one
    fallback_reason: Optional[str] = None
    fuse: bool = False
    tiling: Dict[str, Any] = dataclasses.field(default_factory=dict)
    sparsity: float = 0.0
    value_dtype: str = "float32"         # executed bank value-storage dtype
    flops: float = 0.0
    hbm_bytes: float = 0.0
    staging_stall_s: float = 0.0
    est_s: float = 0.0
    wall_s: Optional[float] = None       # timed mode only

    @property
    def fell_back(self) -> bool:
        return self.fallback_reason is not None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ExecutionReport:
    """One ``CnnEngine`` forward, attributed per conv op."""

    method: str                          # the method the caller requested
    batch: int
    in_shape: Tuple[int, ...]
    dtype: str
    ops: List[OpReport] = dataclasses.field(default_factory=list)
    jit_cache_hit: Optional[bool] = None
    plan_bound: bool = False             # engine had a bound (vs auto) plan
    timed: bool = False
    rung: Optional[str] = None           # degradation-ladder rung executed

    @property
    def fallback_ops(self) -> List[OpReport]:
        return [o for o in self.ops if o.fell_back]

    @property
    def fallback_count(self) -> int:
        return len(self.fallback_ops)

    @property
    def methods_executed(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            out[o.method_executed] = out.get(o.method_executed, 0) + 1
        return out

    @property
    def est_s(self) -> float:
        return sum(o.est_s for o in self.ops)

    def to_dict(self) -> dict:
        return {
            "method": self.method, "batch": self.batch,
            "in_shape": list(self.in_shape), "dtype": self.dtype,
            "jit_cache_hit": self.jit_cache_hit,
            "plan_bound": self.plan_bound, "timed": self.timed,
            "rung": self.rung,
            "fallback_count": self.fallback_count,
            "methods_executed": self.methods_executed,
            "ops": [o.to_dict() for o in self.ops],
        }

    def format(self) -> str:
        """Human-readable per-op table (the paper's per-layer breakdown)."""
        lines = [
            f"ExecutionReport method={self.method} batch={self.batch} "
            f"jit={'hit' if self.jit_cache_hit else 'miss'} "
            f"fallbacks={self.fallback_count}"
            + (f" rung={self.rung}" if self.rung is not None else ""),
            f"{'layer':<22} {'planned':<11} {'executed':<11} "
            f"{'provenance':<13} {'fallback':<20} {'est_us':>9} "
            f"{'stall_us':>9} {'wall_us':>9}",
        ]
        for o in self.ops:
            wall = f"{o.wall_s * 1e6:9.1f}" if o.wall_s is not None else (
                " " * 8 + "-")
            lines.append(
                f"{o.name:<22} {o.method_planned:<11} {o.method_executed:<11} "
                f"{o.provenance:<13} {o.fallback_reason or '-':<20} "
                f"{o.est_s * 1e6:9.1f} {o.staging_stall_s * 1e6:9.1f} {wall}")
        return "\n".join(lines)

    def emit_spans(self, tracer: Tracer) -> None:
        """Lay the per-op roofline estimates out as sequential spans on the
        tracer's ``roofline`` lane.

        The default (untimed) engine does not synchronise between ops, so
        per-op wall segmentation needs the timed mode; the estimated timeline still names every op, its
        method, provenance, and any fallback — what the Chrome-trace view
        is for.  Timed-mode wall spans are emitted separately by
        ``CnnEngine.forward_timed`` on the ``wall`` lane.
        """
        import time
        t = time.perf_counter()
        for o in self.ops:
            tracer.complete(
                o.name, start_s=t, dur_s=o.est_s, cat="conv.roofline",
                tid=TID_ROOFLINE,
                args={"estimated": True, "method": o.method_executed,
                      "planned": o.method_planned,
                      "provenance": o.provenance,
                      "fallback": o.fallback_reason,
                      "fuse": o.fuse, "sparsity": o.sparsity,
                      "value_dtype": o.value_dtype,
                      "flops": o.flops, "hbm_bytes": o.hbm_bytes,
                      "staging_stall_s": o.staging_stall_s})
            t += max(o.est_s, 1e-9)
