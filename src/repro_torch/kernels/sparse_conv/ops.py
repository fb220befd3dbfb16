"""Public wrapper around the ELL direct sparse conv kernel.

Port of ``repro/kernels/sparse_conv/ops.py``.  Handles pad_in, index
packing, the card's schedule (``resolve_schedule``, and ``tile_candidates``
for the autotuner), the fused epilogue operands, quantised banks (their
scale row goes to the kernel), and nnz-balanced banks: an ``EllConv`` carrying a row permutation
runs the kernel in bank row order, with bias and residual gathered into that
order on the way in and the output inverse-permuted on the way out.

There is no fallback.  The reference falls back to its pure-JAX direct path
when the packed indices bust the TPU's 2 MiB SMEM (``smem_infeasible``, e.g.
ResNet-50 res5 3x3 at 224 px) or no VMEM tiling fits; the CUDA kernel reads
its indices from device memory and stages a channel chunk at a time, so
every sparse layer of the three nets has a schedule, and a layer without
one raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.direct_conv import out_spatial, pad_in
from repro_torch.core.sparse_format import EllConv, inverse_permutation
from repro_torch.kernels import budget
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel
from repro_torch.kernels.sparse_conv.ref import (BF16_OFFSET_LIMIT,
                                                 bf16_offsets, pixel_row,
                                                 slab_geometry, slab_width)


@dataclasses.dataclass(frozen=True)
class EllSchedule:
    """One launch of the ELL kernel: ``tm`` output channels by ``tp`` output
    pixels a block, input channels in chunks of ``cc``, the input slab
    ``rows`` padded rows high (a 1x1 conv: the padded image's rows), the
    ``pipeline``d (double-buffered) or blocking copy schedule, and whether
    a lane reads its pixels in ``paired`` neighbours, one 32-bit word of
    two bf16 inputs each (bf16 activations at stride 1: a staged conv's
    slab then keeps its plane shifted by one element beside it)."""

    tm: int
    tp: int
    cc: int
    rows: int
    pipeline: bool
    paired: bool = False


def resolve_schedule(m: int, k: int, e: int, f: int, *, n: int = 1,
                     c: Optional[int] = None, r: int = 1, s: int = 1,
                     stride: int = 1, hp: Optional[int] = None,
                     wp: Optional[int] = None, tm: Optional[int] = None,
                     tp: Optional[int] = None,
                     pipeline: Optional[bool] = None, itemsize: int = 4,
                     paired: bool = False,
                     ) -> Tuple[Optional[EllSchedule], Optional[str]]:
    """The block schedule ``sparse_conv`` launches, as a pure function.

    The geometry: ``n`` images, ``c`` input channels (default ``k``), an
    ``r`` x ``s`` filter at ``stride`` on the padded ``hp`` x ``wp`` input
    (default the output's extent of a stride-1 window), of ``itemsize``
    bytes an element (4: f32, 2: bf16; a bf16 slab is half an f32 one's
    bytes, so its chunks hold twice the channels, and its width is even:
    ``ref.slab_width``).  Returns
    ``(EllSchedule, None)``, or ``(None, reason)`` when a pinned ``tm`` or
    ``tp`` is one the kernel does not take or the block's shared memory
    would not fit.  Without pins, the tile is the first of
    ``budget.ELL_TILES`` (``ELL_1X1_TILES`` for a 1x1 conv) that still
    gives the card ``budget.ELL_MIN_BLOCKS`` blocks; the chunk of channels
    fills about ``budget.ELL_SLAB_BYTES`` with the schedule's stages.
    ``pipeline=None`` takes the pipelined schedule where its two stages
    fit, ``False`` the blocking one; ``True`` that does not fit falls back
    to blocking, as the reference's does.  A 1x1 conv stages nothing (its
    kernel reads the input straight from L1): one chunk of all ``c``
    channels, ``rows`` the padded image's, never pipelined.

    ``paired`` asks for a bf16 bank's schedule on bf16 activations
    (``ops.sparse_conv`` asks for it with such a bank): the tiles in the
    order of ``ELL_TILES_BF16`` and, where stride 1 and an even pixel count
    a lane allow, the ``paired`` slab, which is always blocking (its two
    planes take the second stage's room; the bf16 ablation found blocking
    as fast or faster at every main-path layer); a 1x1 conv also needs an
    even output and padded width.  ``pipeline=True`` keeps the unpaired
    pipelined schedule.
    """
    direct = r == s == 1
    paired = paired and itemsize == 2
    order = (budget.ELL_1X1_TILES if direct else budget.ELL_TILES_BF16
             if paired else budget.ELL_TILES)
    tiles = [(t, p) for t, p in order
             if (tm is None or t == tm)
             and (tp is None or budget.WARP * p == tp)]
    if tm is not None and not any(t == tm for t, _ in budget.ELL_TILES):
        return None, "unsupported_tm"
    if not tiles:
        return None, "unsupported_tp"
    c = k if c is None else c
    hp = (e - 1) * stride + r if hp is None else hp
    wp = (f - 1) * stride + s if wp is None else wp
    if not direct:
        wp = slab_width(wp, itemsize)
    hs, ws, st = slab_geometry(hp, wp, r, s, e, f, stride)
    wq = f if direct else pixel_row(ws, f, st)
    tm, px = tiles[-1]
    for t, p in tiles:
        if (-(-n * e * wq // (budget.WARP * p)) * -(-m // t)
                >= budget.ELL_MIN_BLOCKS):
            tm, px = t, p
            break
    tp = budget.WARP * px
    paired = paired and stride == 1 and px % 2 == 0
    if direct:
        # a 1x1 conv stages nothing (no halo to share), so nothing is
        # pipelined: one run a row over all c channels of hp-row images
        return EllSchedule(tm, tp, c, hp, False,
                           paired and f % 2 == 0 and wp % 2 == 0), None
    rows = budget.ell_slab_rows(n, e, wq, hs, st, r, tp)
    per_channel = budget.ell_stage_bytes(1, rows, ws, 0, itemsize) + rows * 4
    for pair in ((True, False) if paired and pipeline is not True
                 else (False,)):
        pipe = not pair and (pipeline is None or pipeline)
        cc = max(1, min(c, budget.ELL_SLAB_BYTES // (2 if pipe or pair else 1)
                        // per_channel))
        fits = lambda p: budget.smem_fits(  # noqa: E731
            budget.ell_smem_bytes(tm, cc, c, rows, ws, s, p, itemsize, pair))
        if not fits(False) or (pair and bf16_offsets(
                cc, rows, ws, s, rs=r * s, paired=True) > BF16_OFFSET_LIMIT):
            continue
        return EllSchedule(tm, tp, cc, rows, pipe and fits(True), pair), None
    return None, "smem_infeasible"


def tile_candidates(m: int, k: int, e: int, f: int, *, n: int = 1,
                    c: Optional[int] = None, r: int = 1, s: int = 1,
                    stride: int = 1, hp: Optional[int] = None,
                    wp: Optional[int] = None,
                    pipeline: Optional[bool] = None, itemsize: int = 4,
                    ) -> List[Tuple[int, int]]:
    """Every ``(tm, tp)`` tile ``resolve_schedule`` accepts at this
    geometry, in the schedule's order of preference (``budget.ELL_TILES``,
    ``ELL_1X1_TILES`` for a 1x1 conv): the autotuner's candidate space."""
    order = budget.ELL_1X1_TILES if r == s == 1 else budget.ELL_TILES
    out = []
    for tm, px in order:
        sched, _ = resolve_schedule(m, k, e, f, n=n, c=c, r=r, s=s,
                                    stride=stride, hp=hp, wp=wp, tm=tm,
                                    tp=budget.WARP * px, pipeline=pipeline,
                                    itemsize=itemsize)
        if sched is not None:
            out.append((sched.tm, sched.tp))
    return out


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


def sparse_conv(x: torch.Tensor, ell: EllConv, *, stride: int = 1,
                padding: int = 0, tm: Optional[int] = None,
                tp: Optional[int] = None,
                bias: Optional[torch.Tensor] = None, fuse_relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                pipeline: Optional[bool] = None,
                layer: Optional[str] = None,
                packed_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Direct sparse convolution + fused epilogue through the ELL kernel.

    (N, C, H, W) f32 or bf16 input, ELL bank for (M, C, R, S) weights
    (f32 or bf16, or a quantised int8 or e4m3 bank with its scales; any of
    them with either input, as the reference) -> (N, M, E, F) in x's dtype
    (the reference's ``ops.py:351``).  ``bias`` (per channel, f32),
    ``fuse_relu`` and ``residual`` (shaped like the output, in x's dtype)
    run in-kernel on the f32 sums, rounded once to x's dtype.
    ``pipeline`` picks the copy schedule as in the reference: ``True``
    double-buffers the staged input (the copy of the next channel chunk
    under the sums of this one), ``False`` blocks, ``None`` pipelines where
    the second stage fits (``resolve_schedule`` reports which it took); the
    two give the same bits.  ``layer`` names the conv in errors.
    ``packed_idx`` is the bank's ``pack_indices``, for a caller that packs
    once per bank; it is packed here when not given.
    """
    m, c, r, s = ell.shape
    n, cx, h, w = x.shape
    if cx != c:
        raise ValueError(f"input has C={cx} but filters expect C={c}")
    if residual is not None and residual.dtype != x.dtype:
        raise ValueError(f"sparse_conv: residual is {residual.dtype}, the "
                         f"input {x.dtype}; the kernel takes one dtype")
    e, f = out_spatial(h, w, r, s, stride, padding)
    size = x.element_size()
    sched, reason = resolve_schedule(
        m, ell.k, e, f, n=n, c=c, r=r, s=s, stride=stride,
        hp=h + 2 * padding, wp=w + 2 * padding, tm=tm, tp=tp,
        pipeline=pipeline, itemsize=size,
        paired=ell.value.dtype == torch.bfloat16)
    if sched is None:
        raise ValueError(
            f"sparse_conv{'' if layer is None else ' ' + layer}: no kernel "
            f"schedule ({reason}) for m={m} k={ell.k} e={e} f={f} tm={tm} "
            f"tp={tp}")
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
    xpad = pad_in(x, padding)
    wp = w + 2 * padding
    if r * s > 1 and slab_width(wp, size) != wp:
        xpad = F.pad(xpad, (0, 1))   # an even bf16 slab row (slab_width)
    out = sparse_conv_kernel(
        xpad, ell.value, packed_idx, ell.nnz,
        b.contiguous(), None if res is None else res.contiguous(),
        rs=r * s, s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu,
        schedule=sched, scale=ell.scale)
    if ell.perm is not None:
        out = out.index_select(1, inverse_permutation(ell.perm).long())
    return out
