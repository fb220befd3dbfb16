"""How late the server took requests in: the 95th percentile (nearest
rank) over the window's requests of submission time minus due time, in
ms.  The serving loop submits only between ticks, so a request due during
a tick waits for it."""
from escoin_bench.metric_math import p95


def read(run):
    value = p95(run.spans.get("late", []))
    return None if value is None else value * 1e3
