"""BCSR matmul: CUDA kernel, launcher, plain version, wrapper."""
