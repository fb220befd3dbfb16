"""cuDNN's share of the roofline on the dense convs: the bound of the
layers the engine ran dense (``yardstick``) over the device time of the
kernels that the library convolution's ATen op launched, in the profiled
slice."""
from escoin_bench import profiling
from escoin_bench.metric_math import roofline_pct

CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution",
            "aten::convolution", "aten::conv2d")


def read(run):
    return roofline_pct(run, "dense",
                        profiling.launched_by(run.trace, CONV_OPS))
