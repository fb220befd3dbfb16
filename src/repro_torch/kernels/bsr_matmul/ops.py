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

Blocks: the kernel takes any (bm, bn) whose sides are multiples of 16
(the reference's default (128, 128) among them) as it is.  A bank of any
other block (8, 12, 24 or 100 rows; 40 columns) is re-tiled once per bank
on its device (``ref.retile_bcsr``, cached with the cast above): each tile
zero filled to the next multiples of 16, which costs the bank
gm KB (bm' bn' - bm bn) elements more (twice the bank at (8, 128)).  Each
call then spreads x's column blocks of bn to bn' with zero columns (only
where bn is not a multiple of 16) and keeps the first bm of each bm'
outputs.  A bank too wide for a stage of the ``rows`` schedule's ring
(``budget.bsr_matmul_rows_width``: bn about 880 and up) has its tiles cut
side by side into narrower ones (``ref.split_bcsr``), once per bank and
cached the same way, a copy of the bank's bytes; x is then read as it is.
``meta`` tensors (the dry run) are not re-tiled: the op's flop formula
counts the reference's tiles.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.kernels import _build, budget
from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul_kernel
from repro_torch.kernels.bsr_matmul.ref import (retile_bcsr, retiled_block,
                                                split_bcsr)


def _bank(w: BcsrMatrix, dtype: torch.dtype, retile: bool,
          width: int) -> BcsrMatrix:
    """w with tiles in ``dtype``, re-tiled where ``retile`` and cut to
    ``width`` columns where narrower than its (re-tiled) block: the bank
    itself, or its copy, made once per bank."""
    if w.blocks.dtype == dtype and not retile and width == w.block[1]:
        return w

    def make():
        bank = dataclasses.replace(w, blocks=w.blocks.to(dtype))
        bank = retile_bcsr(bank) if retile else bank
        return (split_bcsr(bank, width) if width != bank.block[1]
                else bank)
    return _build.cached("bsr_matmul_tiles", (w.blocks,),
                         (dtype, retile, width), make)


def bsr_matmul(x: torch.Tensor, w: BcsrMatrix) -> torch.Tensor:
    """y = x @ W.T for BCSR weight W of logical shape (M, N).

    x: (..., N) any leading dims.  Returns (..., M) in x.dtype, from sums
    in the promoted dtype of x and the tiles.
    """
    m, n = w.shape
    bm, bn = w.block
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != weight N {n}")
    lead = x.shape[:-1]
    dt = torch.promote_types(x.dtype, w.blocks.dtype)
    real = x.device.type != "meta"
    retile = real and not budget.bsr_matmul_native(bm, bn)
    bm2, bn2 = retiled_block(w.block) if retile else (bm, bn)
    width = budget.bsr_matmul_rows_width(bn2) if real else bn2
    xb = x.reshape(-1, n).to(dt)
    if n % bn:
        xb = torch.nn.functional.pad(xb, (0, (-n) % bn))
    if bn2 != bn:  # each block of bn columns spread to bn2, zero filled
        rows = xb.shape[0]
        xb = torch.nn.functional.pad(xb.reshape(rows, -1, bn),
                                     (0, bn2 - bn)).reshape(rows, -1)
    xb = xb.contiguous()
    if xb.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        xb = xb.clone()
    bank = _bank(w, dt, retile, width)
    out = bsr_matmul_kernel(xb, bank.blocks, bank.blockcol, bank.nblocks,
                            out_dtype=x.dtype)
    if bm2 != bm:  # the first bm outputs of each block-row of bm2
        out = out.reshape(out.shape[0], -1, bm2)[:, :, :bm].reshape(
            out.shape[0], -1)
    return out[:, :m].reshape(lead + (m,))
