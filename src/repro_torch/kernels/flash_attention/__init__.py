"""Flash attention, forward and backward: CUDA kernels, launchers, plain
versions, and the autograd wrapper."""
