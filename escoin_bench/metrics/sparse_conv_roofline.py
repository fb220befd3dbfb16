"""The ELL kernel's (the paper's direct sparse conv) share of its
roofline: the bound of the layers the engine ran on it (``yardstick``)
over the device time of the kernels named ``sparse_conv``, in the
profiled slice."""
from escoin_bench import profiling
from escoin_bench.metric_math import roofline_pct


def read(run):
    return roofline_pct(run, "pallas",
                        profiling.named(run.trace, "sparse_conv"))
