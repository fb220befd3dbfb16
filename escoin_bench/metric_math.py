"""Arithmetic shared by the per-layer readers."""
from __future__ import annotations

import math
import statistics
from typing import List, Optional


def median_ms(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) * 1e3 if xs else None


def roofline_pct(run, method: str, device_s: float) -> Optional[float]:
    """The layers' bound over the device time of the kernels that ran
    them, in the profiled slice; nothing where either is 0."""
    bound = run.forwards_traced * sum(l["bound_s"] for l in run.layers
                                      if l["method"] == method)
    if bound <= 0 or device_s <= 0:
        return None
    return 100.0 * bound / device_s


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def p95(xs: List[float]) -> Optional[float]:
    """The nearest-rank 95th percentile."""
    xs = sorted(xs)
    if not xs:
        return None
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]
