"""Launcher of the CUDA ELL direct sparse conv kernel (``csrc/sparse_conv.cu``).

Replaces ``sparse_conv_pallas`` (``repro/kernels/sparse_conv/kernel.py``).
``sparse_conv_kernel`` takes the kernel's operands; for CUDA tensors it
launches the kernel on the current stream, for CPU tensors it runs the plain
version (``ref.py``), and for anything else it raises.  There is no other
way out: a launch that CUDA refuses raises too.

``sparse_conv_kernel.launches`` counts the kernel's launches in this
process.  Only the CUDA branch adds to it, once per launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_conv.ref import sparse_conv_plain

_SYMBOL = "sparse_conv_f32"
# Channel tiles the source instantiates (its template switch).
TM_CHOICES = (8,)


def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_conv")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    _build.check_operand("sparse_conv", name, t, dtype, shape, device)


def _launch(xpad, value, packed_idx, nnz, bias, residual, *, rs, s, e, f,
            stride, fuse_relu, tm, tp, ks) -> torch.Tensor:
    n, c, hp, wp = xpad.shape
    m, k = value.shape
    dev = xpad.device
    _check(xpad, "xpad", torch.float32, (n, c, hp, wp), dev)
    _check(value, "value", torch.float32, (m, k), dev)
    _check(packed_idx, "packed_idx", torch.int32, (m, k), dev)
    _check(nnz, "nnz", torch.int32, (m,), dev)
    _check(bias, "bias", torch.float32, (m,), dev)
    if residual is not None:
        _check(residual, "residual", torch.float32, (n, m, e, f), dev)
    if tm not in TM_CHOICES:
        raise ValueError(f"sparse_conv: tm={tm} not one of {TM_CHOICES}")
    if c * hp * wp >= 2**31 or m * k >= 2**31:
        raise ValueError("sparse_conv: one image or the bank exceeds int32 offsets")
    if (e - 1) * stride + rs // s > hp or (f - 1) * stride + s > wp:
        raise ValueError("sparse_conv: output extent reads past the padded input")
    out = torch.empty((n, m, e, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), _SYMBOL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xpad.data_ptr(), value.data_ptr(), packed_idx.data_ptr(),
                 nnz.data_ptr(), bias.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), n, c, hp, wp, m, k, rs, s, e, f, stride,
                 tm, tp, ks, int(fuse_relu), stream)
    _build.check(err, "sparse_conv")
    sparse_conv_kernel.launches += 1
    return out


def sparse_conv_kernel(xpad: torch.Tensor, value: torch.Tensor,
                       packed_idx: torch.Tensor, nnz: torch.Tensor,
                       bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None, *, rs: int,
                       s: int, e: int, f: int, stride: int = 1,
                       fuse_relu: bool = False, tm: int = 8, tp: int = 256,
                       ks: int = 256) -> torch.Tensor:
    """The ELL direct sparse conv with its fused epilogue.

    xpad (N, C, Hp, Wp) f32 padded input; value (M, K) f32; packed_idx
    (M, K) int32 ``c*RS + r*S + s``; nnz (M,) int32; bias (M,) f32; residual
    optional (N, M, E, F) f32.  ``tm`` output channels, ``tp`` output
    pixels (threads) and ``ks`` staged nonzeros per row make one block's
    schedule (``ops.resolve_schedule``).  Returns (N, M, E, F) f32.
    """
    kw = dict(rs=rs, s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu)
    if xpad.device.type == "cuda":
        return _launch(xpad, value, packed_idx, nnz, bias, residual, tm=tm,
                       tp=tp, ks=ks, **kw)
    if xpad.device.type == "cpu":
        return sparse_conv_plain(xpad, value, packed_idx, nnz, bias, residual,
                                 **kw)
    raise ValueError(f"sparse_conv: no kernel for device {xpad.device}")


sparse_conv_kernel.launches = 0
