"""Flash-attention forward: CUDA kernel, launcher, plain version, wrapper."""
