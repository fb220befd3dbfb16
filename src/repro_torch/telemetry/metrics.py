"""Process-global metrics registry: counters, gauges, histograms (copy of
``repro/telemetry/metrics.py``).

Dependency-free (stdlib only) so every layer of the stack — Pallas kernel
wrappers, the tuner, the engine, the serving scheduler — can import it
without cycles.  The registry is a plain dict of name -> metric; callers
get-or-create through :func:`counter` / :func:`gauge` / :func:`histogram`
and the whole table exports as one JSON-able dict via :func:`snapshot`.

Instrumentation sites guard on ``repro_torch.telemetry.is_enabled()`` (a single
flag check) so the disabled path records nothing and costs nothing; the
metric objects themselves are always safe to touch.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Union

# Histogram sample cap: quantiles are computed over the most recent window
# (serving runs are long; an unbounded list would grow with uptime).
MAX_SAMPLES = 65536


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written level (queue depth, active slots, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Sample distribution with count/sum/min/max and p50/p95/p99 quantiles.

    Samples beyond :data:`MAX_SAMPLES` roll the window (count/sum stay
    lifetime-accurate; quantiles describe the recent window).
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_samples")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._samples) >= MAX_SAMPLES:
            del self._samples[: MAX_SAMPLES // 2]
        self._samples.append(v)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the sample window (0 when empty)."""
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        idx = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
        return xs[idx]

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": self.mean,
                "p50": self.p50, "p95": self.p95, "p99": self.p99}


MetricT = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> metric table with typed get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[str, MetricT] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls) -> MetricT:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name))
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str) -> Optional[MetricT]:
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: metric dict}, sorted by name."""
        return {k: m.to_dict() for k, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics


# The process-global registry every subsystem records into.
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> Dict[str, dict]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
