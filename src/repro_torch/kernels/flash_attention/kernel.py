"""Launcher of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``).

Replaces ``_fwd_call`` (``repro/kernels/flash_attention/kernel.py``), the
forward of the reference's flash attention; its two backward kernels wait
for the training slice.  ``flash_attention_fwd`` takes q (B, H, T, d) and
k, v (B, KV, S, d), each with a contiguous last axis and any other strides
(so the model's (B, T, H, d) tensors go in as transposed views, without a
copy); for CUDA tensors it launches the kernel on the current stream, for
CPU tensors it runs the plain version (``ref.py``), and for anything else
it raises.  A launch that CUDA refuses raises too.

``flash_attention_fwd.launches`` counts the kernel's launches in this
process.  Only the CUDA branch adds to it, once per launch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, budget
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

_SYMBOL = "flash_attention_fwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    _build.check_operand("flash_attention", name, t, dtype, shape, device,
                         rows_strided=True)


def _launch(q, k, v, sc, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not one of "
                         f"{list(DTYPES)}")
    _check(q, "q", q.dtype, (b, h, t, d), dev)
    _check(k, "k", q.dtype, (b, kv, s, d), dev)
    _check(v, "v", q.dtype, (b, kv, s, d), dev)
    if d not in budget.FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not one of "
                         f"{budget.FLASH_HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} heads over {kv} kv heads")
    if not budget.smem_fits(budget.flash_smem_bytes(d)):
        raise ValueError("flash_attention: chunks bust shared memory")
    # O in q's memory layout: a (B, T, H, d) buffer seen as (B, H, T, d)
    # when q is a transposed view of the model's tensor.
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    fn = getattr(_lib(), _SYMBOL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, kv, t, s, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(sc), int(causal), DTYPES[q.dtype],
                 stream)
    _build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sc: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: q (B, H, T, d), k/v (B, KV, S, d), f32 or bf16 ->
    O (B, H, T, d) in q's dtype and lse (B, H, T) f32."""
    if q.device.type == "cuda":
        return _launch(q, k, v, sc, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sc=sc, causal=causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_fwd.launches = 0
