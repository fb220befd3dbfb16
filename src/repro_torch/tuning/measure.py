"""Candidate scoring: wall-clock measurement with an analytical fallback.

Port of ``repro/tuning/measure.py``.  Two scoring modes, both returning
seconds (lower is better):

  ``mode="wall"``     -- warm-up, then the median of timed calls
                         (``time_fn``): CUDA events around each call on the
                         card, the host clock on the CPU.  On the card every
                         method is measured, the two kernels included; on
                         the CPU ``pallas`` and ``bsr`` run their plain
                         versions, whose time says nothing of the kernels,
                         so there they are scored by roofline only
                         (``measurable``).
  ``mode="roofline"`` -- the analytic max(compute, memory) bound over the
                         card's constants (``launch/roofline.py``), each
                         method priced at the unit its kernel issues on.

The byte accounting is the reference's: the input, output and weight
streams, the unfused epilogue's extra passes (``epilogue_bytes``), the
permuted bank's output gather (``permute_bytes``), a quantised bank's
narrow values plus its scale row (``_value_stream_bytes``), and, given the
layer's weights, the BCSR bank's true kept tiles (``bcsr_true_kept``).
One term is the port's own: ``lowered`` and ``csr-direct`` run no kernel
here but plain PyTorch loops, which pass over the output once a slot
(``plain_loop_bytes``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.direct_conv import dense_conv, direct_sparse_conv
from repro_torch.core.lowering import lowered_sparse_conv
from repro_torch.core.sparse_format import (balance_ell_conv,
                                            bcsr_conv_from_dense,
                                            ell_from_dense,
                                            ell_from_dense_conv,
                                            quantize_values)
from repro_torch.kernels.bsr_conv.kernel import split_weights
from repro_torch.kernels.bsr_conv.ops import bsr_conv
from repro_torch.kernels.sparse_conv.ops import (apply_epilogue,
                                                 pack_indices, sparse_conv)
from repro_torch.launch.roofline import (ELL_FLOPS, F32_FLOPS, HBM_BW,
                                         TF32_FLOPS, value_itemsize)
from repro_torch.tuning.space import Candidate, ConvGeometry


def halo_extent(t: int, stride: int, r: int) -> int:
    """Input rows/cols one output tile of ``t`` positions touches."""
    return (t - 1) * stride + r


def _value_stream_bytes(n_values: float, m_rows: int, itemsize: int,
                        value_dtype: str) -> float:
    """Bytes of one sparse value stream: the values at their storage width
    plus, for a quantised dtype, the per-output-channel f32 scale row."""
    if value_dtype == "float32":
        return float(n_values) * itemsize
    return float(n_values) * value_itemsize(value_dtype) + 4.0 * m_rows


class TimingStats(float):
    """Median wall seconds with the (min, max) spread riding along: a
    ``float`` equal to the p50, with ``.min`` and ``.max``."""

    __slots__ = ("min", "max")

    def __new__(cls, p50: float, tmin: Optional[float] = None,
                tmax: Optional[float] = None) -> "TimingStats":
        self = super().__new__(cls, p50)
        self.min = float(p50 if tmin is None else tmin)
        self.max = float(p50 if tmax is None else tmax)
        return self

    @property
    def p50(self) -> float:
        return float(self)

    @property
    def spread(self) -> float:
        return self.max - self.min

    def __repr__(self) -> str:
        return (f"TimingStats(p50={float(self):.3e}, min={self.min:.3e}, "
                f"max={self.max:.3e})")


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            device=None) -> TimingStats:
    """(min, p50, max) seconds of ``fn(*args)`` after ``warmup`` calls, as
    a :class:`TimingStats`.  On a CUDA ``device`` each call is timed by
    CUDA events recorded around it (device time on the stream, the call's
    launches included); elsewhere by the host clock."""
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    times = []
    if cuda:
        torch.cuda.synchronize(dev)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for start, end in pairs:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize(dev)
        times = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return TimingStats(times[len(times) // 2], times[0], times[-1])


# ---------------------------------------------------------------------------
# analytic roofline scoring
# ---------------------------------------------------------------------------

def _itemsize(g: ConvGeometry) -> int:
    return 2 if g.dtype in ("bfloat16", "float16") else 4


def epilogue_bytes(g: ConvGeometry, fused: bool) -> float:
    """Bytes the conv's epilogue (bias / ReLU / shortcut) moves: unfused,
    every stage a full round trip of the output; fused, the bias row and
    (for bottleneck tails) one read of the shortcut."""
    dout = float(g.batch * g.m * g.e * g.f * 4)
    bias = float(g.m * 4)
    if fused:
        return bias + (dout if g.residual else 0.0)
    extra = 2 * dout + bias                       # bias pass
    if g.relu:
        extra += 2 * dout                         # ReLU pass
    if g.residual:
        extra += 2 * dout + dout                  # add pass + shortcut read
    return extra


def permute_bytes(g: ConvGeometry, permuted: bool) -> float:
    """Bytes the nnz-balanced bank's output gather back to natural channel
    order moves: one read and one write of the output, and the
    permutation row."""
    if not permuted:
        return 0.0
    return 2.0 * g.batch * g.m * g.e * g.f * 4 + g.m * 4


def staged_input_bytes(g: ConvGeometry, cand: Candidate) -> float:
    """Input bytes the kernel stages over the launch: one halo'd block per
    (image, spatial tile).  The port's candidates leave (te, tf) unset,
    the whole extent: the input, once."""
    e, f = g.e, g.f
    te = min(cand.te or e, e)
    tf = min(cand.tf or f, f)
    cells = ((e + te - 1) // te) * ((f + tf - 1) // tf)
    return float(g.batch * cells * g.c * halo_extent(te, g.stride, g.r)
                 * halo_extent(tf, g.stride, g.s) * _itemsize(g))


def plain_loop_bytes(g: ConvGeometry, k_pad: int) -> float:
    """Bytes the plain ``lowered`` and ``csr-direct`` methods move beyond
    their operands: both are PyTorch loops over the K padded slots of the
    ELL rows, each step a gathered (N, M, E*F) operand written and read
    and the f32 sums read and written, four passes of the output a slot.
    (The reference's XLA fuses that loop; the port runs no kernel for
    them.)"""
    return 4.0 * k_pad * g.batch * g.m * g.e * g.f * 4


def _pallas_terms(g: ConvGeometry, cand: Candidate):
    """(compute_s, staged_s, other_mem_s) of an ELL kernel candidate.

    Compute: the true multiply-adds (each row's run stops at its nnz, so
    the bound is permutation-invariant) at ``ELL_FLOPS``, the kernel's
    issue rate (a rounded multiply and add apart, and one shared-memory
    read each).  Other memory: the output, the value stream and its
    4-byte index (the reference's accounting), the epilogue and the
    permute gather.
    """
    k_pad = g.k_est(cand.pad_to or 8)
    fl = 2.0 * g.batch * g.m * g.row_nnz_est * g.e * g.f
    dout = float(g.batch * g.m * g.e * g.f * 4)
    ell_bytes = (_value_stream_bytes(g.m * k_pad, g.m, _itemsize(g),
                                     cand.value_dtype)
                 + float(g.m * k_pad * 4))
    other = (dout + ell_bytes + epilogue_bytes(g, fused=cand.fuse)
             + permute_bytes(g, cand.permute))
    return (fl / ELL_FLOPS, staged_input_bytes(g, cand) / HBM_BW,
            other / HBM_BW)


def bcsr_true_kept(w_dense: np.ndarray, bm: int, bn: int) -> float:
    """Mean kept (any-nonzero) tiles per block-row of the bank a (bm,
    bn)-blocked ``bcsr_conv_from_dense`` would build from ``w_dense``."""
    w = np.asarray(w_dense)
    m = w.shape[0]
    flat = w.reshape(m, -1)
    n2 = flat.shape[1]
    pm, pn = (-m) % bm, (-n2) % bn
    wp = np.pad(flat, ((0, pm), (0, pn)))
    gbm, gbn = wp.shape[0] // bm, wp.shape[1] // bn
    tiles = wp.reshape(gbm, bm, gbn, bn).transpose(0, 2, 1, 3)
    keep = (tiles != 0).any(axis=(2, 3))
    return max(1.0, float(keep.sum(axis=1).mean()))


def _bsr_products(cand: Candidate) -> int:
    """TF32 products the BCSR kernel takes a multiply-add: three of split
    halves, two for a quantised bank (its values are exact in TF32)."""
    return 3 if cand.value_dtype == "float32" else 2


def _bsr_terms(g: ConvGeometry, cand: Candidate,
               kept_override: Optional[float] = None):
    """(compute_s, staged_s, other_mem_s) of a BCSR kernel candidate: the
    kept tiles' multiply-adds as ``_bsr_products`` TF32 products on the
    tensor cores; the input once; the output, the kept tiles' value stream
    and the epilogue.  Kept tiles assume block-structured pruning at the
    layer's sparsity unless ``kept_override`` gives the bank's own."""
    bm, bn = cand.block_m or 8, cand.block_n or 128
    gbm, _, kept = g.bsr_grid(bm, bn)
    if kept_override is not None:
        kept = kept_override
    fl = 2.0 * g.batch * gbm * kept * bm * bn * g.e * g.f
    compute_s = _bsr_products(cand) * fl / TF32_FLOPS
    dout = float(g.batch * gbm * bm * g.e * g.f * 4)
    w_bytes = _value_stream_bytes(gbm * kept * bm * bn, gbm * bm,
                                  _itemsize(g), cand.value_dtype)
    other = dout + w_bytes + epilogue_bytes(g, fused=cand.fuse)
    return (compute_s, staged_input_bytes(g, cand) / HBM_BW, other / HBM_BW)


def staging_stall_s(g: ConvGeometry, cand: Candidate) -> float:
    """Seconds the kernel waits on its staged input under this schedule:
    the whole staging time when blocking, the part of it compute cannot
    hide when pipelined (the ELL kernel's ``pipeline``; the BCSR kernel
    always gathers a column ahead)."""
    terms = (_bsr_terms if cand.method == "bsr" else _pallas_terms)(g, cand)
    t_fl, t_stage, _ = terms
    if cand.method == "pallas" and not cand.pipeline:
        return t_stage
    return max(0.0, t_stage - t_fl)


def roofline_estimate(g: ConvGeometry, cand: Candidate,
                      w_dense: Optional[np.ndarray] = None,
                      bsr_kept: Optional[float] = None) -> float:
    """max(compute, memory) time bound of one candidate, in seconds.

      dense       cuDNN with TF32 off: dense operations at ``F32_FLOPS``;
                  input + output + dense weights + the unfused epilogue.
      lowered     the im2col matrix written and read, the padded ELL rows'
                  operations at ``F32_FLOPS``, and the plain loop's passes
                  over the output (``plain_loop_bytes``).
      csr-direct  input + output + ELL, every padded slot's operations at
                  ``F32_FLOPS``, and the plain loop's passes.
      pallas      the ELL kernel (``_pallas_terms``): blocking, staging
                  then max(compute, other traffic); pipelined,
                  max(compute, staging + other traffic).
      bsr         the BCSR kernel (``_bsr_terms``): its tiles' copies and
                  gathers run a column ahead of the products, so
                  max(compute, staging + other traffic).  ``w_dense`` (or
                  ``bsr_kept``, its precomputed mean kept tiles a
                  block-row) prices the bank the weights really give.
    """
    n, m, c = g.batch, g.m, g.c
    rs = g.r * g.s
    e, f = g.e, g.f
    itemsize = _itemsize(g)
    din = float(n * c * g.hp * g.wp * itemsize)
    dout = float(n * m * e * f * 4)
    dense_fl = 2.0 * n * m * c * rs * e * f
    ep_unfused = epilogue_bytes(g, fused=False)
    if cand.method == "dense":
        return max(dense_fl / F32_FLOPS,
                   (din + dout + itemsize * m * c * rs + ep_unfused) / HBM_BW)
    if cand.method == "bsr":
        kept = bsr_kept
        if kept is None and w_dense is not None:
            kept = bcsr_true_kept(w_dense, cand.block_m or 8,
                                  cand.block_n or 128)
        t_c, t_stage, t_other = _bsr_terms(g, cand, kept_override=kept)
        return max(t_c, t_stage + t_other)
    k_pad = g.k_est(cand.pad_to or 8)
    ell_bytes = float(m * k_pad * (itemsize + 4))  # value + packed index
    padded_fl = 2.0 * n * m * k_pad * e * f
    loop = plain_loop_bytes(g, k_pad)
    if cand.method == "lowered":
        im2col = float(n * c * rs * e * f * itemsize)
        return max(padded_fl / F32_FLOPS,
                   (2 * im2col + dout + ell_bytes + ep_unfused + loop)
                   / HBM_BW)
    if cand.method == "csr-direct":
        return max(padded_fl / F32_FLOPS,
                   (din + dout + ell_bytes + ep_unfused + loop) / HBM_BW)
    if cand.method == "pallas":
        t_fl, t_stage, t_other = _pallas_terms(g, cand)
        if cand.pipeline:
            return max(t_fl, t_stage + t_other)
        return t_stage + max(t_fl, t_other)
    raise ValueError(cand.method)


def candidate_cost(g: ConvGeometry, cand: Candidate,
                   w_dense: Optional[np.ndarray] = None,
                   bsr_kept: Optional[float] = None) -> dict:
    """Roofline attribution of one candidate: its operations, bytes,
    staging-stall seconds and ``roofline_estimate`` bound, as one dict
    (what the engine's ExecutionReport charges each op)."""
    n, m, c = g.batch, g.m, g.c
    rs = g.r * g.s
    e, f = g.e, g.f
    itemsize = _itemsize(g)
    din = float(n * c * g.hp * g.wp * itemsize)
    dout = float(n * m * e * f * 4)
    ep_unfused = epilogue_bytes(g, fused=False)
    est_s = roofline_estimate(g, cand, w_dense=w_dense, bsr_kept=bsr_kept)
    stall = (staging_stall_s(g, cand)
             if cand.method in ("pallas", "bsr") else 0.0)
    if cand.method == "dense":
        flops = 2.0 * n * m * c * rs * e * f
        hbm = din + dout + itemsize * m * c * rs + ep_unfused
    elif cand.method == "bsr":
        bm, bn = cand.block_m or 8, cand.block_n or 128
        gbm, _, kept = g.bsr_grid(bm, bn)
        if bsr_kept is not None:
            kept = bsr_kept
        elif w_dense is not None:
            kept = bcsr_true_kept(w_dense, bm, bn)
        flops = 2.0 * n * gbm * kept * bm * bn * e * f
        hbm = (staged_input_bytes(g, cand) + dout
               + _value_stream_bytes(gbm * kept * bm * bn, gbm * bm,
                                     itemsize, cand.value_dtype)
               + epilogue_bytes(g, fused=cand.fuse))
    elif cand.method == "pallas":
        flops = 2.0 * n * m * g.row_nnz_est * e * f
        k_pad = g.k_est(cand.pad_to or 8)
        hbm = (staged_input_bytes(g, cand) + dout
               + _value_stream_bytes(m * k_pad, m, itemsize, cand.value_dtype)
               + float(m * k_pad * 4)
               + epilogue_bytes(g, fused=cand.fuse)
               + permute_bytes(g, cand.permute))
    elif cand.method in ("lowered", "csr-direct"):
        k_pad = g.k_est(cand.pad_to or 8)
        flops = 2.0 * n * m * k_pad * e * f
        ell_bytes = float(m * k_pad * (itemsize + 4))
        loop = plain_loop_bytes(g, k_pad)
        if cand.method == "lowered":
            im2col = float(n * c * rs * e * f * itemsize)
            hbm = 2 * im2col + dout + ell_bytes + ep_unfused + loop
        else:
            hbm = din + dout + ell_bytes + ep_unfused + loop
    else:
        raise ValueError(cand.method)
    return {"flops": float(flops), "hbm_bytes": float(hbm),
            "staging_stall_s": float(stall), "est_s": float(est_s)}


# ---------------------------------------------------------------------------
# wall-clock scoring
# ---------------------------------------------------------------------------

def build_runner(g: ConvGeometry, cand: Candidate, w_dense: np.ndarray,
                 device) -> Callable:
    """``fn(x)`` running one candidate on a pruned dense (M, C, R, S) bank
    on ``device``: the conv *and* its epilogue (bias, and the ReLU and
    shortcut the geometry names), unfused as separate ops or, for a
    ``fuse`` kernel candidate, in-kernel.  Banks are built (and a
    candidate's quantised, balanced, packed or split forms made) here,
    once, as the engine keeps them."""
    dev = torch.device(device)
    rng = np.random.default_rng(1)
    bias = torch.zeros((g.m,), dtype=torch.float32, device=dev)
    res = (torch.from_numpy(rng.standard_normal(
        (g.batch, g.m, g.e, g.f)).astype(np.float32)).to(dev)
        if g.residual else None)
    conv = dict(stride=g.stride, padding=g.pad)

    def epilogue(y):
        return apply_epilogue(y, bias, g.relu, res)

    if cand.method == "dense":
        w = torch.from_numpy(np.ascontiguousarray(w_dense)).to(dev)
        return lambda x: epilogue(dense_conv(x, w, **conv))
    pad_to = cand.pad_to or 8
    if cand.method == "lowered":
        ell2d = ell_from_dense(w_dense.reshape(g.m, -1), pad_to=pad_to,
                               device=dev)
        return lambda x: epilogue(lowered_sparse_conv(x, ell2d, g.r, g.s,
                                                      **conv))
    if cand.method == "bsr":
        bcc = bcsr_conv_from_dense(
            w_dense, block=(cand.block_m or 8, cand.block_n or 128),
            device=dev)
        halves = None
        if cand.value_dtype != "float32":
            bcc = quantize_values(bcc, cand.value_dtype)
        else:
            halves = split_weights(bcc.blocks)
        if cand.fuse:
            return lambda x: bsr_conv(x, bcc, bias=bias, fuse_relu=g.relu,
                                      residual=res, halves=halves, **conv)
        return lambda x: epilogue(bsr_conv(x, bcc, halves=halves, **conv))
    ell = ell_from_dense_conv(w_dense, pad_to=pad_to, device=dev)
    if cand.method == "csr-direct":
        return lambda x: epilogue(direct_sparse_conv(x, ell, **conv))
    if cand.method == "pallas":
        if cand.value_dtype != "float32":
            ell = quantize_values(ell, cand.value_dtype)
        if cand.permute:
            ell = balance_ell_conv(ell)
        packed = pack_indices(ell)
        kw = dict(conv, tm=cand.tm, pipeline=cand.pipeline,
                  packed_idx=packed)
        if cand.fuse:
            return lambda x: sparse_conv(x, ell, bias=bias, fuse_relu=g.relu,
                                         residual=res, **kw)
        return lambda x: epilogue(sparse_conv(x, ell, **kw))
    raise ValueError(cand.method)


def measure_candidate(g: ConvGeometry, cand: Candidate, w_dense: np.ndarray,
                      x: torch.Tensor, *, warmup: int = 1,
                      iters: int = 5) -> TimingStats:
    """Median seconds (with the spread) of one candidate on ``x``'s
    device."""
    with torch.no_grad():
        runner = build_runner(g, cand, w_dense, x.device)
        return time_fn(runner, x, warmup=warmup, iters=iters,
                       device=x.device)


def measurable(cand: Candidate, backend: Optional[str] = None) -> bool:
    """Whether wall-timing this candidate times its kernel: on the card
    every method; elsewhere the two kernels run their plain versions, so
    ``pallas`` and ``bsr`` are scored by roofline only."""
    return cand.method not in ("pallas", "bsr") or backend == "cuda"
