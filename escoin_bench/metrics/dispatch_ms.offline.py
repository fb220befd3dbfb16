"""The median host time of one ``engine(x, method)`` call in the window,
until it returns (the op loop's launches; no synchronisation)."""
from escoin_bench.metric_math import median_ms


def read(run):
    return median_ms(run.spans.get("dispatch", []))
