"""Diagnostic vocabulary for the pre-flight static verifier.

Port of ``repro/analysis/diagnostics.py``.  Every rule pack (schedule,
plan-cache, program, CUDA source lints) reports findings as
:class:`Diagnostic` records: a stable dotted rule id, a severity, where the
finding anchors (net / layer / location), and a human message.  The records
are machine-readable (``to_dict``) so the CLI's ``--json`` mode and CI can
read them without parsing prose.

``REASON_RULES`` is the contract between the verifier and what the card's
dispatch reports: every reason code the engine's fallbacks
(``repro_torch.telemetry.fallback.REASONS``) or the kernels' schedule probes
(``kernels/sparse_conv/ops.resolve_schedule``,
``kernels/bsr_conv/ops.resolve_bsr_schedule``) can give has the static
rule that catches it pre-flight.  ``no_feasible_tiling`` and
``nondividing_tm`` never arise on the card; they stay mapped, to the card's
counterparts, so that a report or plan file that carries them still reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

SEVERITIES = ("error", "warning", "info")

# Runtime reason code -> the static rule that catches it pre-flight.
REASON_RULES = {
    # the engine's two plan fallbacks, as on the reference
    "stale_plan_no_block": "plan.stale_bsr_no_block",
    "value_dtype_mismatch": "sched.value_dtype_mismatch",
    # the card's schedule probes (a plan entry they refuse raises)
    "smem_infeasible": "sched.smem_budget",
    "unsupported_tm": "sched.unsupported_tm",
    "unsupported_tp": "sched.unsupported_tile",
    "unsupported_tile": "sched.unsupported_tile",
    "unsupported_block": "sched.unsupported_block",
    # the reference's TPU reasons: no tiling of the staged memory fits
    # (the card stages in shared memory), a pinned tile the kernel cannot
    # take
    "no_feasible_tiling": "sched.smem_budget",
    "nondividing_tm": "sched.unsupported_tm",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static finding: rule id + severity + anchor + message."""

    rule: str
    severity: str
    message: str
    net: Optional[str] = None
    layer: Optional[str] = None
    location: Optional[str] = None  # file path, cache key, or op index

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not one of {SEVERITIES}")

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "net": self.net,
                "layer": self.layer, "location": self.location}

    def format(self) -> str:
        anchor = " ".join(
            f"{k}={v}" for k, v in (("net", self.net), ("layer", self.layer),
                                    ("at", self.location)) if v)
        head = f"{self.severity:<7} {self.rule}"
        return (f"{head} [{anchor}] {self.message}" if anchor
                else f"{head} {self.message}")


@dataclasses.dataclass
class Report:
    """The verifier's output: all diagnostics plus what was checked."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    checked: List[str] = dataclasses.field(default_factory=list)

    def extend(self, diags: List[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def by_severity(self, severity: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Diagnostic]:
        return self.by_severity("warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok,
                "counts": {s: len(self.by_severity(s)) for s in SEVERITIES},
                "checked": list(self.checked),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}

    def format_human(self) -> str:
        order = {s: i for i, s in enumerate(SEVERITIES)}
        lines = [d.format() for d in sorted(
            self.diagnostics, key=lambda d: (order[d.severity], d.rule))]
        counts = ", ".join(f"{len(self.by_severity(s))} {s}(s)"
                           for s in SEVERITIES)
        lines.append(f"checked: {', '.join(self.checked) or '(nothing)'}")
        lines.append(f"result: {'OK' if self.ok else 'FAIL'} ({counts})")
        return "\n".join(lines)


class PreflightError(RuntimeError):
    """Strict-mode bind failed: the static verifier found errors."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = [d for d in diagnostics if d.severity == "error"]
        lines = [f"pre-flight verification failed "
                 f"({len(self.diagnostics)} error(s)):"]
        lines += [f"  {d.format()}" for d in self.diagnostics]
        super().__init__("\n".join(lines))
