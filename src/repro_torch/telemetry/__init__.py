"""Execution telemetry: the metrics registry the serving scheduler records
into.

Port of the part of ``repro/telemetry`` the scheduler calls (``metrics``,
copied, and the on/off switch).  Off by default; every instrumentation site
guards on :func:`is_enabled`, a single module-level flag read, so the
disabled path records nothing.  Traces, fallback reports and execution
reports come with the slices that use them.
"""
from __future__ import annotations

import contextlib

from repro_torch.telemetry import metrics
from repro_torch.telemetry.metrics import (REGISTRY, counter, gauge,
                                           histogram, snapshot)

__all__ = ["REGISTRY", "counter", "enable", "enabled", "gauge", "histogram",
           "is_enabled", "reset", "snapshot"]

_ENABLED = False


def is_enabled() -> bool:
    """The single flag every instrumentation site checks."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


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


def reset() -> None:
    """Clear the metrics (tests)."""
    metrics.reset()
