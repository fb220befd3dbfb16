"""Launcher of the CUDA ELL direct sparse conv kernel (``csrc/sparse_conv.cu``).

Replaces ``sparse_conv_pallas`` (``repro/kernels/sparse_conv/kernel.py``).
``sparse_conv_kernel`` takes the kernel's operands; for CUDA tensors it
launches the kernel on the current stream, for CPU tensors it runs the plain
version (``ref.py``), and for anything else it raises.  There is no other
way out: a launch that CUDA refuses raises too.  The kernel takes f32 or
bf16 activations (the input, the residual and the output in one dtype;
bias and scale f32) and the bank stretched for its slabs
(``ref.stretch_bank``: (offset, value) pairs of an f32 bank, one word a
nonzero of a quantised int8 or e4m3 bank, with its scale row, or of a bf16
bank on bf16 activations, read from the schedule's paired slab where it
has one: ``ref.entry_format``); the launcher stretches each bank once per
schedule and keeps the result (``_build.cached``), so a forward launches
no stretching ops after its first.

``sparse_conv_kernel.launches`` counts the kernel's launches in this
process, ``.int8_launches`` and ``.e4m3_launches`` those on a quantised
bank, ``.bf16_launches`` those on bf16 activations.  Only the CUDA branch
adds to them, once per launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_conv.ref import (entry_format, slab_geometry,
                                                 slab_width,
                                                 sparse_conv_plain,
                                                 stretch_bank)

_SYMBOL = "sparse_conv_ell"
# the C entry point's parameters: 7 pointers, 20 ints, the stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
# value storage dtype -> the kernel's qtype (a bf16 bank's values go to it
# widened to f32, exactly, unless it takes them as bf16 words)
QTYPES = {torch.float32: 0, torch.bfloat16: 0, torch.int8: 1,
          torch.float8_e4m3fn: 2}
# the qtype of a bf16 bank's words (ref.entry_format)
QTYPE_BF16_WORDS = 3
# activation dtype -> the kernel's act
ACTS = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_conv")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    _build.check_operand("sparse_conv", name, t, dtype, shape, device)


def _launch(xpad, value, packed_idx, nnz, bias, residual, scale, *, rs, s,
            e, f, stride, fuse_relu, schedule) -> torch.Tensor:
    n, c, hp, wp = xpad.shape
    m, k = value.shape
    dev = xpad.device
    if xpad.dtype not in ACTS:
        raise ValueError(f"sparse_conv: xpad has dtype {xpad.dtype}, "
                         f"expected one of {sorted(map(str, ACTS))}")
    act = ACTS[xpad.dtype]
    _check(xpad, "xpad", xpad.dtype, (n, c, hp, wp), dev)
    if value.dtype not in QTYPES:
        raise ValueError(f"sparse_conv: value has dtype {value.dtype}, "
                         f"expected one of {sorted(map(str, QTYPES))}")
    qtype = QTYPES[value.dtype]
    _check(value, "value", value.dtype, (m, k), dev)
    if (scale is None) != (qtype == 0):
        raise ValueError("sparse_conv: an int8 or e4m3 bank needs its scale "
                         "row, an f32 bank has none")
    if scale is not None:
        _check(scale, "scale", torch.float32, (m,), dev)
    _check(packed_idx, "packed_idx", torch.int32, (m, k), dev)
    _check(nnz, "nnz", torch.int32, (m,), dev)
    _check(bias, "bias", torch.float32, (m,), dev)
    if residual is not None:
        _check(residual, "residual", xpad.dtype, (n, m, e, f), dev)
    if schedule is None:
        raise ValueError("sparse_conv: a launch needs its schedule "
                         "(ops.resolve_schedule)")
    if xpad.numel() >= 2**31 or m * k >= 2**31 or n * m * e * f >= 2**31:
        raise ValueError("sparse_conv: the input, bank or output exceeds "
                         "int32 offsets")
    if (e - 1) * stride + rs // s > hp or (f - 1) * stride + s > wp:
        raise ValueError("sparse_conv: output extent reads past the padded input")
    sc = schedule
    size = xpad.element_size()
    if rs > 1 and wp != slab_width(wp, size):
        raise ValueError(f"sparse_conv: a {xpad.dtype} input's padded width "
                         f"{wp} is odd; its slabs copy 4 bytes at a time "
                         f"(ops.sparse_conv pads one more column)")
    # a 1x1 conv reads xpad directly: offsets c*Hp*Wp, in int32 bytes
    ws = wp if rs == 1 else slab_geometry(hp, wp, rs // s, s, e, f, stride)[1]
    if rs == 1 and xpad.numel() * size >= 2**31:
        raise ValueError("sparse_conv: a 1x1 conv's input exceeds int32 "
                         "byte offsets")
    words, paired = entry_format(value.dtype, size, rs, s, ws, sc)
    if paired and (stride != 1 or (rs == 1 and (f % 2 or wp % 2))
                   or (rs > 1 and sc.pipeline)):
        raise ValueError("sparse_conv: a paired schedule needs stride 1 "
                         "and a blocking slab (a 1x1 conv an even output "
                         "and padded width)")
    pairs, rowptr = _build.cached(
        "sparse_conv_stretch", (value, packed_idx, nnz),
        (rs, s, ws, sc.rows, sc.cc, c, size, words, paired),
        lambda: stretch_bank(value, packed_idx, nnz, rs=rs, s=s, ws=ws,
                             rows=sc.rows, cc=sc.cc, c=c, itemsize=size,
                             words=words, paired=paired and rs > 1))
    out = torch.empty((n, m, e, f), dtype=xpad.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), _SYMBOL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xpad.data_ptr(), pairs.data_ptr(), rowptr.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 bias.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), n, c, hp, wp, m, k, rs, s, e, f, stride,
                 sc.tm, sc.tp // 32, sc.cc, sc.rows, int(sc.pipeline),
                 int(fuse_relu), QTYPE_BF16_WORDS if words else qtype, act,
                 int(paired), stream)
    _build.check(err, "sparse_conv")
    sparse_conv_kernel.launches += 1
    if act:
        sparse_conv_kernel.bf16_launches += 1
    if qtype == 1:
        sparse_conv_kernel.int8_launches += 1
    elif qtype == 2:
        sparse_conv_kernel.e4m3_launches += 1
    return out


def sparse_conv_kernel(xpad: torch.Tensor, value: torch.Tensor,
                       packed_idx: torch.Tensor, nnz: torch.Tensor,
                       bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None, *, rs: int,
                       s: int, e: int, f: int, stride: int = 1,
                       fuse_relu: bool = False, schedule=None,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ELL direct sparse conv with its fused epilogue.

    xpad (N, C, Hp, Wp) f32 or bf16 padded input (a bf16 one of an even
    Wp unless the conv is 1x1: ``ref.slab_width``); value (M, K) f32 or
    bf16, or int8 or float8_e4m3fn with ``scale`` (M,) f32 (a quantised
    bank); packed_idx (M, K) int32 ``c*RS + r*S + s``, in (c, r, s) order
    within a row up to its nnz (what ``ell_from_dense_conv`` builds); nnz
    (M,) int32; bias (M,) f32; residual optional (N, M, E, F) in xpad's
    dtype.  ``schedule`` is the ``ops.EllSchedule`` of the launch
    (``ops.resolve_schedule``, at xpad's item size).  Returns (N, M, E, F)
    in xpad's dtype: f32 sums, rounded once in the epilogue.
    """
    kw = dict(rs=rs, s=s, e=e, f=f, stride=stride, fuse_relu=fuse_relu)
    if xpad.device.type == "cuda":
        return _launch(xpad, value, packed_idx, nnz, bias, residual, scale,
                       schedule=schedule, **kw)
    if xpad.device.type == "cpu":
        return sparse_conv_plain(xpad, value, packed_idx, nnz, bias, residual,
                                 scale=scale, **kw)
    raise ValueError(f"sparse_conv: no kernel for device {xpad.device}")


sparse_conv_kernel.launches = 0
# of those, the launches on an int8 and on an e4m3 bank
sparse_conv_kernel.int8_launches = 0
sparse_conv_kernel.e4m3_launches = 0
# of those, the launches on bf16 activations
sparse_conv_kernel.bf16_launches = 0
