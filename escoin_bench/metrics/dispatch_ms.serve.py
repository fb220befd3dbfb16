"""The median host time of one bucket engine call inside a serving tick,
until it returns (before the server copies the result to the host)."""
from escoin_bench.metric_math import median_ms


def read(run):
    return median_ms(run.spans.get("dispatch", []))
