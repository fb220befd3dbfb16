"""Public wrapper around the BCSR conv kernel.

Port of ``repro/kernels/bsr_conv/ops.py``.  Handles pad_in, the card's
schedule (``resolve_bsr_schedule``) and channel padding: the format blocks M
up to gbm*bm, so bias and residual are padded in and the output is sliced
back to M.  On f32 inputs the kernel takes the tiles split into TF32
halves (``kernel.split_weights``), which a caller keeping the bank passes
in; on bf16 inputs bf16 (or quantised) tiles as they are.
There is no fallback: a bank whose block the kernel does not take, or
whose stages would not fit shared memory, raises.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.direct_conv import out_spatial, pad_in
from repro_torch.core.sparse_format import BcsrConv
from repro_torch.kernels import budget
from repro_torch.kernels.bsr_conv.kernel import BM_CHOICES, BN, bsr_conv_kernel

# The (bm, bn) block shapes the autotuner enumerates, the reference's
# ladder: bn the kernel's 128, bm 8 to 64.
BLOCK_CANDIDATES = ((8, 128), (16, 128), (32, 128), (64, 128))


def resolve_bsr_schedule(bm: int, bn: int, e: int, f: int, *, n: int = 1,
                         m: Optional[int] = None, crs: Optional[int] = None,
                         n_tile: Optional[int] = None,
                         wgs: Optional[int] = None,
                         value_dtype: str = "float32", itemsize: int = 4,
                         ) -> Tuple[Optional[Tuple[int, int]], Optional[str]]:
    """The block schedule ``bsr_conv`` launches, as a pure function:
    ``((n_tile, wgs), None)``, a tile of ``n_tile`` output channels by
    ``wgs`` x 64 pixels, or ``(None, reason)`` when the block is not one the
    kernel takes or its stages bust shared memory.

    The geometry: ``n`` images, ``m`` output channels (default one group),
    ``crs`` = C*R*S flattened columns (default one block column);
    ``value_dtype`` the tiles' storage (a quantised bank stages a byte a
    weight); ``itemsize`` the activation's (2: bf16, whose operand is half the
    bytes of a TF32 one and has no lo half, so its tiles reach N = 128:
    ``budget.bsr_conv_tiles``).  Without pins, the tile is the first of
    those holding whole block-rows whose blocks number
    ``budget.BSR_CONV_MIN_BLOCKS`` or more; a pinned tile must be one the
    source instantiates."""
    if bm not in BM_CHOICES:
        return None, "unsupported_block"
    tiles = [(t, w) for t, w in budget.bsr_conv_tiles(itemsize)
             if t % bm == 0
             and (n_tile is None or t == n_tile) and (wgs is None or w == wgs)]
    if not tiles:
        return None, "unsupported_tile"
    kbc = -(-(bn if crs is None else crs) // bn)
    m = tiles[0][0] if m is None else m
    pick = tiles[-1]
    for t, w in tiles:
        blocks = -(-n * e * f // (64 * w)) * -(-m // t)
        if blocks >= budget.BSR_CONV_MIN_BLOCKS:
            pick = (t, w)
            break
    if not budget.smem_fits(budget.bsr_conv_smem_bytes(
            bm, bn, pick[0], kbc, budget.value_itemsize(value_dtype),
            itemsize)):
        return None, "smem_infeasible"
    if bn != BN:
        return None, "unsupported_block"
    return pick, None


def bsr_tile_candidates(bm: int, bn: int, e: int, f: int, *, n: int = 1,
                        m: Optional[int] = None, crs: Optional[int] = None,
                        value_dtype: str = "float32", itemsize: int = 4,
                        ) -> List[Tuple[int, int]]:
    """Every ``(n_tile, wgs)`` tile ``resolve_bsr_schedule`` accepts for a
    (bm, bn) block at this geometry, in ``budget.bsr_conv_tiles``' order
    at the activation's ``itemsize``: the autotuner's feasibility probe for
    a block shape."""
    out = []
    for t, w in budget.bsr_conv_tiles(itemsize):
        sched, _ = resolve_bsr_schedule(bm, bn, e, f, n=n, m=m, crs=crs,
                                        n_tile=t, wgs=w,
                                        value_dtype=value_dtype,
                                        itemsize=itemsize)
        if sched is not None:
            out.append(sched)
    return out


def bsr_conv(x: torch.Tensor, bc: BcsrConv, *, stride: int = 1,
             padding: int = 0, n_tile: Optional[int] = None,
             wgs: Optional[int] = None,
             bias: Optional[torch.Tensor] = None, fuse_relu: bool = False,
             residual: Optional[torch.Tensor] = None,
             layer: Optional[str] = None, halves=None) -> torch.Tensor:
    """Block-sparse convolution + fused epilogue through the BCSR kernel.

    (N, C, H, W) f32 or bf16 input, BCSR bank for (M, C, R, S) weights
    (f32 or bf16, or a quantised int8 or e4m3 bank with its scales; a bf16
    input takes a bf16 or quantised one) -> (N, M, E, F) in x's dtype (the
    reference's ``ops.py:196``); ``residual`` in x's dtype, ``bias`` f32.
    ``layer`` names the conv in errors; ``halves`` is
    ``kernel.split_weights(bc.blocks)`` for a caller that splits the bank
    once on f32 inputs (split here when not given).
    """
    m, c, r, s = bc.shape
    gbm, _, bm, bn = bc.blocks.shape
    n, cx, h, w = x.shape
    if cx != c:
        raise ValueError(f"input has C={cx} but filters expect C={c}")
    if residual is not None and residual.dtype != x.dtype:
        raise ValueError(f"bsr_conv: residual is {residual.dtype}, the "
                         f"input {x.dtype}; the kernel takes one dtype")
    e, f = out_spatial(h, w, r, s, stride, padding)
    sched, reason = resolve_bsr_schedule(bm, bn, e, f, n=n, m=gbm * bm,
                                         crs=c * r * s, n_tile=n_tile,
                                         wgs=wgs, value_dtype=bc.value_dtype,
                                         itemsize=x.element_size())
    if sched is None:
        raise ValueError(
            f"bsr_conv{'' if layer is None else ' ' + layer}: no kernel "
            f"schedule ({reason}) for block=({bm}, {bn}) e={e} f={f}")
    n_tile, wgs = sched
    mpad = gbm * bm
    if bias is not None and mpad == m:
        b = bias.float().contiguous()
    else:
        b = torch.zeros((mpad,), dtype=torch.float32, device=x.device)
        if bias is not None:
            b[:m] = bias.float()
    res = residual
    if res is not None and mpad != m:
        res = F.pad(res, (0, 0, 0, 0, 0, mpad - m))
    out = bsr_conv_kernel(
        pad_in(x, padding), bc.blocks, bc.blockcol, bc.nblocks, b,
        None if res is None else res.contiguous(), rs=r * s, s=s, e=e, f=f,
        stride=stride, fuse_relu=fuse_relu, n_tile=n_tile, wgs=wgs,
        halves=halves, scale=bc.scale)
    return out if mpad == m else out[:, :m]
