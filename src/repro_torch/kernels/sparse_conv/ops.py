"""Public wrapper around the ELL direct sparse conv kernel.

Port of ``repro/kernels/sparse_conv/ops.py``.  Handles pad_in, index
packing, the card's schedule (``resolve_schedule``), the fused epilogue
operands, and nnz-balanced banks: an ``EllConv`` carrying a row permutation
runs the kernel in bank row order, with bias and residual gathered into that
order on the way in and the output inverse-permuted on the way out.

There is no fallback.  The reference falls back to its pure-JAX direct path
when the packed indices bust the TPU's 2 MiB SMEM (``smem_infeasible``, e.g.
ResNet-50 res5 3x3 at 224 px) or no VMEM tiling fits; the CUDA kernel reads
its indices from device memory and stages them a slab at a time, so every
sparse layer of the three nets has a schedule, and a layer without one
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.direct_conv import out_spatial, pad_in
from repro_torch.core.sparse_format import EllConv, inverse_permutation
from repro_torch.kernels import budget
from repro_torch.kernels.sparse_conv.kernel import (TM_CHOICES,
                                                    sparse_conv_kernel)

DEFAULT_TM = 8
# Output pixels per block (one thread each) and staged nonzeros per row.
MAX_TP = budget.MAX_THREADS_PER_BLOCK
MAX_KS = 256

Schedule = Tuple[int, int, int]   # (tm, tp, ks)


def pack_indices(ell: EllConv) -> torch.Tensor:
    """Pack (c, r, s) into one int32 per nonzero: c*(R*S) + r*S + s."""
    _, _, r, s = ell.shape
    return (ell.cidx * (r * s) + ell.ridx * s + ell.sidx).to(torch.int32)


def apply_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                   fuse_relu: bool,
                   residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The unfused conv epilogue: the kernel's fused one as separate ops on
    the f32 result, cast back to the input dtype."""
    dtype = y.dtype
    y = y.float()
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    if residual is not None:
        y = y + residual.float()
    if fuse_relu:
        y = torch.relu(y)
    return y.to(dtype)


def default_tp(e: int, f: int) -> int:
    """One thread per output pixel, up to ``MAX_TP`` a block, in whole warps."""
    return min(MAX_TP, -(-(e * f) // budget.WARP) * budget.WARP)


def resolve_schedule(m: int, k: int, e: int, f: int, *,
                     tm: Optional[int] = None, tp: Optional[int] = None,
                     ) -> Tuple[Optional[Schedule], Optional[str]]:
    """The block schedule ``sparse_conv`` launches, as a pure function.

    Returns ``((tm, tp, ks), None)``, or ``(None, reason)`` when a pinned
    ``tm``/``tp`` is one the kernel does not take or the block's shared
    memory would not fit.  With the defaults every geometry has a schedule:
    the staged slab ``ks`` is capped, so K does not enter the shared-memory
    bound.
    """
    tm = DEFAULT_TM if tm is None else tm
    if tm not in TM_CHOICES:
        return None, "unsupported_tm"
    tp = default_tp(e, f) if tp is None else tp
    if not budget.threads_fit(tp):
        return None, "unsupported_tp"
    ks = min(k, MAX_KS)
    if not budget.smem_fits(budget.ell_smem_bytes(tm, ks)):
        return None, "smem_infeasible"
    return (tm, tp, ks), None


def sparse_conv(x: torch.Tensor, ell: EllConv, *, stride: int = 1,
                padding: int = 0, tm: Optional[int] = None,
                tp: Optional[int] = None,
                bias: Optional[torch.Tensor] = None, fuse_relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                layer: Optional[str] = None,
                packed_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Direct sparse convolution + fused epilogue through the ELL kernel.

    (N, C, H, W) f32 input, ELL bank for (M, C, R, S) weights ->
    (N, M, E, F) f32.  ``bias`` (per channel), ``fuse_relu`` and
    ``residual`` (shaped like the output) run in-kernel on the f32 sums.
    ``layer`` names the conv in errors.  ``packed_idx`` is the bank's
    ``pack_indices``, for a caller that packs once per bank; it is packed
    here when not given.
    """
    m, c, r, s = ell.shape
    n, cx, h, w = x.shape
    if cx != c:
        raise ValueError(f"input has C={cx} but filters expect C={c}")
    e, f = out_spatial(h, w, r, s, stride, padding)
    sched, reason = resolve_schedule(m, ell.k, e, f, tm=tm, tp=tp)
    if sched is None:
        raise ValueError(
            f"sparse_conv{'' if layer is None else ' ' + layer}: no kernel "
            f"schedule ({reason}) for m={m} k={ell.k} e={e} f={f} tm={tm} "
            f"tp={tp}")
    tm, tp, ks = sched
    b = (torch.zeros((m,), dtype=torch.float32, device=x.device)
         if bias is None else bias.float())
    res = residual
    if ell.perm is not None:
        perm = ell.perm.long()
        b = b.index_select(0, perm)
        if res is not None:
            res = res.index_select(1, perm)
    if packed_idx is None:
        packed_idx = pack_indices(ell)
    out = sparse_conv_kernel(
        pad_in(x, padding), ell.value, packed_idx, ell.nnz,
        b.contiguous(), None if res is None else res.contiguous(),
        rs=r * s, s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu,
        tm=tm, tp=tp, ks=ks)
    if ell.perm is not None:
        out = out.index_select(1, inverse_permutation(ell.perm).long())
    return out
