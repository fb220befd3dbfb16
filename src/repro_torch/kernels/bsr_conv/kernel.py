"""Launcher of the CUDA BCSR conv kernel (``csrc/bsr_conv.cu``).

Replaces ``bsr_conv_pallas`` (``repro/kernels/bsr_conv/kernel.py``).
``bsr_conv_kernel`` takes the kernel's operands; for CUDA tensors it
launches the kernel on the current stream, for CPU tensors it runs the plain
version (``ref.py``), and for anything else it raises.  A launch that CUDA
refuses raises too.

``bsr_conv_kernel.launches`` counts the kernel's launches in this process.
Only the CUDA branch adds to it, once per launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_conv.ref import bsr_conv_plain

_SYMBOL = "bsr_conv_f32"
# Block heights the source instantiates (its template switch).
BM_CHOICES = (8, 16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_conv")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    _build.check_operand("bsr_conv", name, t, dtype, shape, device)


def _launch(xpad, blocks, blockcol, nblocks, bias, residual, *, rs, s, e, f,
            stride, fuse_relu, tp) -> torch.Tensor:
    n, c, hp, wp = xpad.shape
    gbm, kb_dim, bm, bn = blocks.shape
    mpad = gbm * bm
    dev = xpad.device
    _check(xpad, "xpad", torch.float32, (n, c, hp, wp), dev)
    _check(blocks, "blocks", torch.float32, (gbm, kb_dim, bm, bn), dev)
    _check(blockcol, "blockcol", torch.int32, (gbm, kb_dim), dev)
    _check(nblocks, "nblocks", torch.int32, (gbm,), dev)
    _check(bias, "bias", torch.float32, (mpad,), dev)
    if residual is not None:
        _check(residual, "residual", torch.float32, (n, mpad, e, f), dev)
    if bm not in BM_CHOICES:
        raise ValueError(f"bsr_conv: block height {bm} not one of {BM_CHOICES}")
    if c * hp * wp >= 2**31:
        raise ValueError("bsr_conv: one image exceeds int32 offsets")
    if (e - 1) * stride + rs // s > hp or (f - 1) * stride + s > wp:
        raise ValueError("bsr_conv: output extent reads past the padded input")
    out = torch.empty((n, mpad, e, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), _SYMBOL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xpad.data_ptr(), blocks.data_ptr(), blockcol.data_ptr(),
                 nblocks.data_ptr(), bias.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), n, c, hp, wp, gbm, kb_dim, bm, bn, rs, s, e,
                 f, stride, tp, int(fuse_relu), stream)
    _build.check(err, "bsr_conv")
    bsr_conv_kernel.launches += 1
    return out


def bsr_conv_kernel(xpad: torch.Tensor, blocks: torch.Tensor,
                    blockcol: torch.Tensor, nblocks: torch.Tensor,
                    bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, *, rs: int,
                    s: int, e: int, f: int, stride: int = 1,
                    fuse_relu: bool = False, tp: int = 256) -> torch.Tensor:
    """The BCSR conv with its fused epilogue.

    xpad (N, C, Hp, Wp) f32; blocks (gbm, KB, bm, bn) f32; blockcol (gbm, KB)
    int32; nblocks (gbm,) int32; bias (gbm*bm,) f32; residual optional
    (N, gbm*bm, E, F) f32.  ``tp`` output pixels (threads) per block.
    Returns (N, gbm*bm, E, F) f32; the caller slices off channel padding.
    """
    kw = dict(rs=rs, s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu)
    if xpad.device.type == "cuda":
        return _launch(xpad, blocks, blockcol, nblocks, bias, residual,
                       tp=tp, **kw)
    if xpad.device.type == "cpu":
        return bsr_conv_plain(xpad, blocks, blockcol, nblocks, bias, residual,
                              **kw)
    raise ValueError(f"bsr_conv: no kernel for device {xpad.device}")


bsr_conv_kernel.launches = 0
