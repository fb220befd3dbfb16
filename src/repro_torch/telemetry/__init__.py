"""Execution telemetry: metrics, traces, fallback reporting, reports.

Port of ``repro/telemetry``, stdlib-only at module level like it, so every
layer of the port can import it without cycles:

  metrics   -- process-global registry (counters, gauges, p50/p95/p99
               histograms), ``snapshot()`` exports one JSON-able dict
  trace     -- span/event tracer exporting Chrome-trace-format JSON
               (chrome://tracing, Perfetto) + ``validate_chrome_trace``
  fallback  -- machine-readable fallback reason codes, one-time
               ``SparseFallbackWarning`` (always on), gated counters
  report    -- per-forward ``ExecutionReport``/``OpReport`` built by
               ``CnnEngine`` at dispatch time

Off by default; every instrumentation site guards on :func:`is_enabled`, a
single module-level flag read, so the disabled path records nothing.  The
one always-on signal is the one-time fallback warning.
"""
from __future__ import annotations

import contextlib

from repro_torch.telemetry import metrics
from repro_torch.telemetry.fallback import (REASONS, SparseFallbackWarning,
                                            record_fallback, reset_warnings)
from repro_torch.telemetry.metrics import (REGISTRY, counter, gauge,
                                           histogram, snapshot)
from repro_torch.telemetry.report import ExecutionReport, OpReport
from repro_torch.telemetry.trace import (TID_ROOFLINE, TID_WALL, Tracer,
                                         validate_chrome_trace)

__all__ = [
    "REASONS", "REGISTRY", "SparseFallbackWarning", "TID_ROOFLINE",
    "TID_WALL", "Tracer", "ExecutionReport", "OpReport", "counter",
    "disable", "enable", "enabled", "gauge", "get_tracer", "histogram",
    "is_enabled", "record_fallback", "reset", "reset_warnings", "snapshot",
    "validate_chrome_trace",
]

_ENABLED = False
_TRACER = Tracer()


def is_enabled() -> bool:
    """The single flag every instrumentation site checks."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def enabled():
    """Enable telemetry for the duration of a ``with`` block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    try:
        yield
    finally:
        _ENABLED = prev


def get_tracer() -> Tracer:
    """The process-global tracer (``--trace`` exports it)."""
    return _TRACER


def reset() -> None:
    """Clear metrics, trace events, and fallback-warning dedup (tests)."""
    metrics.reset()
    _TRACER.clear()
    reset_warnings()
