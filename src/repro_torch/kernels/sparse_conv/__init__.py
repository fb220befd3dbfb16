"""ELL direct sparse conv: CUDA kernel, launcher, plain version, wrapper."""
