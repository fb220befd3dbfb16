"""PyTorch/CUDA port of the Escoin sparse-CNN inference stack.

The package mirrors ``src/repro/`` subpackage by subpackage: plain tensor
code is PyTorch, and each Pallas kernel of the JAX package is a CUDA C++
kernel written for Hopper (``kernels/*/csrc``), built with ``nvcc`` at first
use and bound through ``ctypes`` (``kernels/_build.py``).

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA they raise instead of carrying on on the CPU.  On a CPU tensor
each kernel wrapper runs its plain PyTorch version, which is how the CPU
tests exercise the port.

Precision: the port holds its f32 results to the JAX package's f32
convolutions and products, so cuDNN's and cuBLAS's TF32 paths are turned
off for the process when the package is imported.
"""
from __future__ import annotations

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
