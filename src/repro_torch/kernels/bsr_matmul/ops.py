"""Public wrapper around the BCSR matmul kernel.

Port of ``repro/kernels/bsr_matmul/ops.py``: flattens the leading dims of
``x``, pads N up to a multiple of bn, runs the kernel, which writes y in
``x``'s dtype (its f32 sums rounded once, as the reference's cast of its
f32 result), and slices.  The reference also pads the rows to its batch
tile; the CUDA kernel tests its row bounds instead, so rows are never
padded.

Mixed dtypes (f32 activations over a bf16 model's tiles: f32 embeddings on
a bf16 model) run in the promoted dtype, as the reference's
``bcsr_matmul`` sums in f32 and returns x's dtype.  The kernel takes x and
tiles of one dtype, so the operand of the narrower dtype is cast up: bf16
tiles under f32 x are cast to f32 once per bank (``_build.cached``, kept
while the bank lives), and a bf16 x over f32 tiles is cast per call.  On
the card the kernel then sees f32 x and f32 tiles, which run the ``rows``
schedule at any row count; the ``wgmma`` schedule takes bf16 only and
is never reached by f32 x (``kernel.schedule`` picks by dtype).  No
plain version runs on a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul_kernel


def _tiles(w: BcsrMatrix, dtype: torch.dtype) -> torch.Tensor:
    """w's tiles in ``dtype``: the bank itself, or its copy cast up, made
    once per bank."""
    if w.blocks.dtype == dtype:
        return w.blocks
    return _build.cached("bsr_matmul_tiles", (w.blocks,), (dtype,),
                         lambda: w.blocks.to(dtype))


def bsr_matmul(x: torch.Tensor, w: BcsrMatrix) -> torch.Tensor:
    """y = x @ W.T for BCSR weight W of logical shape (M, N).

    x: (..., N) any leading dims.  Returns (..., M) in x.dtype, from sums
    in the promoted dtype of x and the tiles.
    """
    m, n = w.shape
    _, bn = w.block
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != weight N {n}")
    lead = x.shape[:-1]
    dt = torch.promote_types(x.dtype, w.blocks.dtype)
    xb = x.reshape(-1, n).to(dt)
    if n % bn:
        xb = torch.nn.functional.pad(xb, (0, (-n) % bn))
    xb = xb.contiguous()
    if xb.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        xb = xb.clone()
    out = bsr_matmul_kernel(xb, _tiles(w, dt), w.blockcol, w.nblocks,
                            out_dtype=x.dtype)
    return out[:, :m].reshape(lead + (m,))
