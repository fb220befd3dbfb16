"""BCSR direct conv: CUDA kernel, launcher, plain version, wrapper."""
