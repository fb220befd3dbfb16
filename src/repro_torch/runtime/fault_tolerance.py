"""Soft-failure detection for the serving loop.

Port of ``StragglerMonitor`` from ``repro/runtime/fault_tolerance.py``: a
per-step wall-time EWMA with k-sigma straggler flagging, which the serving
scheduler feeds with its tick times.  The restart loop, the failure
classifier and the backoff policy come with the slices that use them.
"""
from __future__ import annotations

import collections
from typing import Optional


class StragglerMonitor:
    """EWMA step-time monitor with k-sigma straggler flagging."""

    def __init__(self, alpha: float = 0.1, k_sigma: float = 3.0,
                 warmup_steps: int = 5):
        self.alpha = alpha
        self.k = k_sigma
        self.warmup = warmup_steps
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0
        self.flags: collections.deque = collections.deque(maxlen=100)

    def observe(self, dt: float) -> bool:
        """Record one step time; returns True if flagged as straggling."""
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.n > self.warmup:
            sigma = max(self.var ** 0.5, 1e-6)
            if dt > self.mean + self.k * sigma and dt > 1.2 * self.mean:
                is_straggler = True
                self.flags.append((self.n, dt, self.mean))
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler
