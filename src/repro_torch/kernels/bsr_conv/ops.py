"""Public wrapper around the BCSR conv kernel.

Port of ``repro/kernels/bsr_conv/ops.py``.  Handles pad_in, the card's
schedule (``resolve_bsr_schedule``) and channel padding: the format blocks M
up to gbm*bm, so bias and residual are padded in and the output is sliced
back to M.  There is no fallback: a bank whose block the kernel does not
take, or whose block would not fit shared memory, raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.direct_conv import out_spatial, pad_in
from repro_torch.core.sparse_format import BcsrConv
from repro_torch.kernels import budget
from repro_torch.kernels.bsr_conv.kernel import BM_CHOICES, bsr_conv_kernel
from repro_torch.kernels.sparse_conv.ops import default_tp


def resolve_bsr_schedule(bm: int, bn: int, e: int, f: int, *,
                         tp: Optional[int] = None,
                         ) -> Tuple[Optional[Tuple[int]], Optional[str]]:
    """The block schedule ``bsr_conv`` launches, as a pure function:
    ``((tp,), None)``, or ``(None, reason)`` when the block height is not
    one the kernel instantiates, ``tp`` is not a whole number of warps
    within the launch bound, or the weight tile busts shared memory."""
    if bm not in BM_CHOICES:
        return None, "unsupported_block"
    tp = default_tp(e, f) if tp is None else tp
    if not budget.threads_fit(tp):
        return None, "unsupported_tp"
    if not budget.smem_fits(budget.bsr_smem_bytes(bm, bn)):
        return None, "smem_infeasible"
    return (tp,), None


def bsr_conv(x: torch.Tensor, bc: BcsrConv, *, stride: int = 1,
             padding: int = 0, tp: Optional[int] = None,
             bias: Optional[torch.Tensor] = None, fuse_relu: bool = False,
             residual: Optional[torch.Tensor] = None,
             layer: Optional[str] = None) -> torch.Tensor:
    """Block-sparse convolution + fused epilogue through the BCSR kernel.

    (N, C, H, W) f32 input, BCSR bank for (M, C, R, S) weights ->
    (N, M, E, F) f32.  ``layer`` names the conv in errors.
    """
    m, c, r, s = bc.shape
    gbm, _, bm, bn = bc.blocks.shape
    n, cx, h, w = x.shape
    if cx != c:
        raise ValueError(f"input has C={cx} but filters expect C={c}")
    e, f = out_spatial(h, w, r, s, stride, padding)
    sched, reason = resolve_bsr_schedule(bm, bn, e, f, tp=tp)
    if sched is None:
        raise ValueError(
            f"bsr_conv{'' if layer is None else ' ' + layer}: no kernel "
            f"schedule ({reason}) for block=({bm}, {bn}) e={e} f={f} tp={tp}")
    (tp,) = sched
    mpad = gbm * bm
    b = torch.zeros((mpad,), dtype=torch.float32, device=x.device)
    if bias is not None:
        b[:m] = bias.float()
    res = residual
    if res is not None and mpad != m:
        res = F.pad(res, (0, 0, 0, 0, 0, mpad - m))
    out = bsr_conv_kernel(
        pad_in(x, padding), bc.blocks, bc.blockcol, bc.nblocks, b,
        None if res is None else res.contiguous(), rs=r * s, s=s, e=e, f=f,
        stride=stride, fuse_relu=fuse_relu, tp=tp)
    return out if mpad == m else out[:, :m]
