"""Public wrapper around the BCSR matmul kernel.

Port of ``repro/kernels/bsr_matmul/ops.py``: flattens the leading dims of
``x``, pads N up to a multiple of bn, runs the kernel, which writes y in
``x``'s dtype (its f32 sums rounded once, as the reference's cast of its
f32 result), and slices.  The reference also pads the rows to its batch
tile; the CUDA kernel tests its row bounds instead, so rows are never
padded.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul_kernel


def bsr_matmul(x: torch.Tensor, w: BcsrMatrix) -> torch.Tensor:
    """y = x @ W.T for BCSR weight W of logical shape (M, N).

    x: (..., N) any leading dims.  Returns (..., M) in x.dtype.
    """
    m, n = w.shape
    _, bn = w.block
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != weight N {n}")
    lead = x.shape[:-1]
    xb = x.reshape(-1, n)
    if n % bn:
        xb = torch.nn.functional.pad(xb, (0, (-n) % bn))
    xb = xb.contiguous()
    if xb.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        xb = xb.clone()
    out = bsr_matmul_kernel(xb, w.blocks, w.blockcol, w.nblocks,
                            out_dtype=x.dtype)
    return out[:, :m].reshape(lead + (m,))
