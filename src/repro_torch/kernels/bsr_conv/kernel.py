"""Launcher of the CUDA BCSR conv kernel (``csrc/bsr_conv.cu``).

Replaces ``bsr_conv_pallas`` (``repro/kernels/bsr_conv/kernel.py``).
``bsr_conv_kernel`` takes the kernel's operands; for CUDA tensors it
launches the kernel on the current stream, for CPU tensors it runs the plain
version (``ref.py``), and for anything else it raises.  A launch that CUDA
refuses raises too.  The kernel runs on the tensor cores: on f32
activations with the f32 operands split into TF32 halves
(``split_weights``; the source says why), on bf16 activations (the input,
the residual and the output in one dtype) with bf16 tiles as they are, one
bf16 product a step; a quantised bank's int8 or e4m3 tiles go to it as they
are, with their scales, on either.  A bf16 bank on f32 activations is
widened (exactly) and split; f32 tiles on bf16 activations are refused
(rounding them to bf16 would not be the reference's f32 product).

``bsr_conv_kernel.launches`` counts the kernel's launches in this process;
``.int8_launches``, ``.e4m3_launches``, ``.bm32_launches``,
``.bm64_launches`` and ``.bf16_launches`` those on a quantised bank, at a
tall block or on bf16 activations.  Only the CUDA branch adds to them,
once per launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.sparse_format import block_column_fault
from repro_torch.kernels import _build, budget
from repro_torch.kernels.bsr_conv.ref import bsr_conv_plain, split_tf32

_SYMBOL = "bsr_conv_tc"
# the C entry point's parameters: 9 pointers, 18 ints, the stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
# Block heights and the width the source instantiates (its tiles, N output
# channels by 64 pixels a warpgroup, are budget.bsr_conv_tiles; a tile
# holds whole block-rows, N % bm == 0).
BM_CHOICES = (8, 16, 32, 64)
BN = 128
# tile storage dtype -> the kernel's qtype (f32 and bf16 tiles: 0)
QTYPES = {torch.float32: 0, torch.bfloat16: 0, torch.int8: 1,
          torch.float8_e4m3fn: 2}
# activation dtype -> the kernel's act
ACTS = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_conv")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def split_weights(blocks: torch.Tensor):
    """The tiles as two TF32 halves kept as f32, hi = tf32(w) and
    lo = tf32(w - hi), the kernel's B operands.  A caller that launches one
    bank many times splits it once (``CnnEngine`` caches the halves beside
    the bank).  A quantised bank is not split: the kernel takes its bytes."""
    return split_tf32(blocks.float())


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    _build.check_operand("bsr_conv", name, t, dtype, shape, device)


def _walkable(blockcol, nblocks, ncols):
    """The kernel finds a group's tiles by (row, block column): a repeated
    column would keep one tile of the two, a column out of range would write
    past its table.  Any order within a row is fine."""
    fault = block_column_fault(blockcol, nblocks, ncols, ascending=False)
    if fault is not None:
        raise ValueError(f"bsr_conv: {fault}")


def _launch(xpad, blocks, blockcol, nblocks, bias, residual, halves, scale,
            *, rs, s, e, f, stride, fuse_relu, n_tile, wgs) -> torch.Tensor:
    n, c, hp, wp = xpad.shape
    gbm, kb_dim, bm, bn = blocks.shape
    mpad = gbm * bm
    dev = xpad.device
    if xpad.dtype not in ACTS:
        raise ValueError(f"bsr_conv: xpad has dtype {xpad.dtype}, "
                         f"expected one of {sorted(map(str, ACTS))}")
    act = ACTS[xpad.dtype]
    _check(xpad, "xpad", xpad.dtype, (n, c, hp, wp), dev)
    if blocks.dtype not in QTYPES:
        raise ValueError(f"bsr_conv: blocks have dtype {blocks.dtype}, "
                         f"expected one of {sorted(map(str, QTYPES))}")
    qtype = QTYPES[blocks.dtype]
    _check(blocks, "blocks", blocks.dtype, (gbm, kb_dim, bm, bn), dev)
    if (scale is None) != (qtype == 0):
        raise ValueError("bsr_conv: int8 or e4m3 tiles need their scales, "
                         "f32 tiles have none")
    if scale is not None:
        _check(scale, "scale", torch.float32, (gbm, bm), dev)
    _check(blockcol, "blockcol", torch.int32, (gbm, kb_dim), dev)
    _check(nblocks, "nblocks", torch.int32, (gbm,), dev)
    _check(bias, "bias", torch.float32, (mpad,), dev)
    if residual is not None:
        _check(residual, "residual", xpad.dtype, (n, mpad, e, f), dev)
    if bm not in BM_CHOICES or bn != BN:
        raise ValueError(f"bsr_conv: block ({bm}, {bn}) not one the kernel "
                         f"takes (height {BM_CHOICES}, width {BN})")
    tiles = budget.bsr_conv_tiles(xpad.element_size())
    if (n_tile, wgs) not in tiles or n_tile % bm:
        raise ValueError(f"bsr_conv: tile ({n_tile}, {wgs}) not one of "
                         f"{tiles} ({xpad.dtype} activations) holding "
                         f"whole block-rows of {bm}")
    if xpad.numel() >= 2**31 or n * mpad * e * f >= 2**31:
        raise ValueError("bsr_conv: the input or output exceeds int32 offsets")
    if (e - 1) * stride + rs // s > hp or (f - 1) * stride + s > wp:
        raise ValueError("bsr_conv: output extent reads past the padded input")
    ncols = -(-c * rs // bn)
    _build.check_once("bsr_conv", (blockcol, nblocks),
                      lambda: _walkable(blockcol, nblocks, ncols))
    if qtype or act:
        whi, wlo = blocks, None
    else:
        whi, wlo = split_weights(blocks) if halves is None else halves
        for name, t in (("w_hi", whi), ("w_lo", wlo)):
            _check(t, name, torch.float32, (gbm, kb_dim, bm, bn), dev)
    out = torch.empty((n, mpad, e, f), dtype=xpad.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), _SYMBOL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xpad.data_ptr(), whi.data_ptr(),
                 None if wlo is None else wlo.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 blockcol.data_ptr(), nblocks.data_ptr(), bias.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), n, c, hp, wp, gbm, kb_dim, bm, bn, rs, s, e,
                 f, stride, n_tile, wgs, int(fuse_relu), qtype, act, stream)
    _build.check(err, "bsr_conv")
    bsr_conv_kernel.launches += 1
    if act:
        bsr_conv_kernel.bf16_launches += 1
    if qtype == 1:
        bsr_conv_kernel.int8_launches += 1
    elif qtype == 2:
        bsr_conv_kernel.e4m3_launches += 1
    if bm == 32:
        bsr_conv_kernel.bm32_launches += 1
    elif bm == 64:
        bsr_conv_kernel.bm64_launches += 1
    return out


def bsr_conv_kernel(xpad: torch.Tensor, blocks: torch.Tensor,
                    blockcol: torch.Tensor, nblocks: torch.Tensor,
                    bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, *, rs: int,
                    s: int, e: int, f: int, stride: int = 1,
                    fuse_relu: bool = False, n_tile: int = 64, wgs: int = 1,
                    halves=None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The BCSR conv with its fused epilogue.

    xpad (N, C, Hp, Wp) f32 or bf16; blocks (gbm, KB, bm, bn) f32 (f32
    activations only) or bf16, or int8 or float8_e4m3fn with ``scale``
    (gbm, bm) f32 (a quantised bank); blockcol (gbm, KB) int32, distinct
    within a row up to its nblocks (checked once per bank); nblocks (gbm,)
    int32; bias (gbm*bm,) f32; residual optional (N, gbm*bm, E, F) in
    xpad's dtype.  ``n_tile`` output channels by ``wgs`` x 64 pixels make
    one block's tile (``ops.resolve_bsr_schedule``); ``halves`` is
    ``split_weights(blocks)`` where the caller keeps it (f32
    activations).  Returns (N, gbm*bm, E, F) in xpad's dtype; the caller
    slices off channel padding.
    """
    kw = dict(rs=rs, s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu)
    if xpad.dtype == torch.bfloat16 and blocks.dtype == torch.float32:
        raise ValueError("bsr_conv: bf16 activations take bf16 or quantised "
                         "tiles, not f32 ones")
    if xpad.device.type == "cuda":
        return _launch(xpad, blocks, blockcol, nblocks, bias, residual,
                       halves, scale, n_tile=n_tile, wgs=wgs, **kw)
    if xpad.device.type == "cpu":
        return bsr_conv_plain(xpad, blocks, blockcol, nblocks, bias, residual,
                              scale=scale, **kw)
    raise ValueError(f"bsr_conv: no kernel for device {xpad.device}")


bsr_conv_kernel.launches = 0
# of those, the launches on an int8 and on an e4m3 bank, and at block
# heights 32 and 64
bsr_conv_kernel.int8_launches = 0
bsr_conv_kernel.e4m3_launches = 0
bsr_conv_kernel.bm32_launches = 0
bsr_conv_kernel.bm64_launches = 0
# of those, the launches on bf16 activations
bsr_conv_kernel.bf16_launches = 0
