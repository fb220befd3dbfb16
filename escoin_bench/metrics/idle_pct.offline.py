"""The share of the profiled slice in which no operation ran on the
device."""
from escoin_bench.metric_math import idle_pct


def read(run):
    return idle_pct(run)
