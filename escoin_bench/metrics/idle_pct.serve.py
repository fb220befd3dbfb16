"""The share of the profiled slice of serving in which no operation ran
on the device."""
from escoin_bench.metric_math import idle_pct


def read(run):
    return idle_pct(run)
