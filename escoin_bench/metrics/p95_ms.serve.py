"""The serving tail: the nearest-rank 95th percentile over every request
of the window, in ms, from when it was due to when its logits reached the
host (a rejected one: until the window closed).  A per-layer metric, not
an end-to-end one: its runs spread too widely to hold a bound (PERF.md,
section 2)."""
from escoin_bench.metric_math import p95


def read(run):
    value = p95(run.spans.get("latency", []))
    return None if value is None else value * 1e3
