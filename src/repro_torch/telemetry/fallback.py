"""Machine-readable fallback reason codes + the always-on one-time warning.

Port of ``repro/telemetry/fallback.py`` with the same codes, so reports
compare across the two packages.  The port's kernels never fall back: a
schedule the card cannot run raises, naming the layer and one of the
kernel codes below.  Only the engine's two decisions about a plan go
through :func:`record_fallback`:

  smem_infeasible       the kernel's schedule does not fit a block's shared
                        memory (raised, never a fallback, in the port)
  no_feasible_tiling    no tiling of the kernel fits this geometry (raised)
  nondividing_tm        a pinned output-channel tile is not one the kernel
                        takes (raised)
  stale_plan_no_block   a plan entry claims ``method="bsr"`` but carries no
                        BCSR block shape (pre-v5 cache document) — the
                        engine runs the dense executor instead
  value_dtype_mismatch  the plan's pinned value-storage dtype disagrees with
                        the already-quantised bank the params carry (e.g. a
                        migrated pre-v6 f32 entry against an int8 bank, or
                        an int8 entry against an fp8 bank) — the engine
                        runs the dense executor rather than silently
                        dequantising/requantising a bank the plan was not
                        scored against

Two consumers, with different lifetimes:

  * a **one-time ``warnings.warn``** (:class:`SparseFallbackWarning`, keyed
    per (kernel, layer-or-geometry, reason)) that fires regardless of
    whether telemetry is enabled — a mis-tuned or stale plan silently
    running the dense-reconstruction path must leave *some* signal;
  * **metrics counters** (``fallback.<kernel>.<reason>`` plus the roll-up
    ``fallback.total``), recorded only when telemetry is enabled.

Callers sit at dispatch time (the decisions are static Python over plan
entries and shapes), before any kernel is launched.
"""
from __future__ import annotations

import warnings
from typing import Optional, Set, Tuple

REASONS = frozenset({
    "smem_infeasible",
    "no_feasible_tiling",
    "nondividing_tm",
    "stale_plan_no_block",
    "value_dtype_mismatch",
})


class SparseFallbackWarning(UserWarning):
    """A sparse conv kernel silently took a fallback execution path."""


# (kernel, layer-or-geometry, reason) triples already warned about.
_WARNED: Set[Tuple[str, str, str]] = set()


def record_fallback(kernel: str, reason: str, *, layer: Optional[str] = None,
                    geometry: str = "", fallback_to: str = "") -> None:
    """Report one fallback decision: warn once per (layer, reason), and
    count it when telemetry is enabled.

    ``kernel`` names the reporting site (``sparse_conv`` / ``bsr_conv`` /
    ``engine``); ``layer`` the conv layer when the caller knows it (the
    geometry string keys the warning otherwise); ``fallback_to`` the path
    actually executed (``csr-direct``, ``dense``, ...).
    """
    if reason not in REASONS:
        raise ValueError(f"unknown fallback reason {reason!r}; "
                         f"one of {sorted(REASONS)}")
    key = (kernel, layer or geometry, reason)
    if key not in _WARNED:
        _WARNED.add(key)
        where = f"layer {layer!r}" if layer else "layer"
        tail = f" -> {fallback_to}" if fallback_to else ""
        warnings.warn(
            f"{kernel}: {where} ({geometry}) fell back{tail}: {reason}",
            SparseFallbackWarning, stacklevel=2)
    from repro_torch import telemetry  # local: telemetry imports this module
    if telemetry.is_enabled():
        from repro_torch.telemetry import metrics
        metrics.counter(f"fallback.{kernel}.{reason}").inc()
        metrics.counter("fallback.total").inc()


def reset_warnings() -> None:
    """Forget which (kernel, layer, reason) triples already warned (tests)."""
    _WARNED.clear()
