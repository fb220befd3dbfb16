"""Launchers of the CUDA flash-attention kernels
(``csrc/flash_attention.cu``): the forward and the two backward kernels.

Replace ``_fwd_call`` and the two ``pallas_call``s of ``_bwd_call``
(``repro/kernels/flash_attention/kernel.py``).  Every operand shaped like
q (B, H, T, d) or k, v (B, KV, S, d) needs a contiguous last axis and takes
any other strides, so the model's (B, T, H, d) tensors go in as transposed
views, without a copy.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch their kernels on
the current stream for CUDA tensors, run the plain versions (``ref.py``)
for CPU tensors, and raise for anything else.  ``flash_attention_bwd``
computes ``delta = rowsum(dO * O)`` with torch ops (``bwd_delta``), as the
reference does with ``jnp`` outside its ``pallas_call``s, then launches
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``, which take CUDA
tensors only.  A launch that CUDA refuses raises.

Every kernel takes any head dim d up to 128 whose rows are a multiple of
16 bytes (d a multiple of 8 in bf16, of 4 in f32; ``ops`` pads any other
d): it runs in the instantiation D = ``budget.flash_head_dim(d)``, the
smallest of ``budget.FLASH_HEAD_DIMS`` at least d, its loads zero past
column d and its stores cut there.  A head dim above 128, or one whose rows
the copies cannot cover, raises before a launch (no fallback on a CUDA
tensor).

All three pick their kernel by dtype, and only by dtype.  bf16 operands go
to the tensor-core kernels (``flash_fwd_tc_kernel``;
``flash_bwd_dq_tc_kernel``; ``flash_bwd_dkv_tc_kernel``, which writes f32
sums per query head into two scratch buffers, then
``flash_dkv_reduce_kernel``, which sums each kv head's group in a fixed
order).  f32 operands go to the split-TF32 kernels
(``flash_fwd_tf32_kernel``, ``flash_bwd_dq_tf32_kernel``,
``flash_bwd_dkv_tf32_kernel``), which keep f32 accuracy on the tensor
cores; with G = H / KV > 1 the last writes f32 sums per query head, which
``flash_dkv_reduce_kernel`` sums as for bf16.  Every kernel loads 16-byte
chunks, so an operand whose address or (b, h, t) strides are not 16-byte
multiples is copied to a contiguous tensor first.

On the CPU the tests hold the split-TF32 kernels' arithmetic through its
plain mirrors (``ref.flash_attention_fwd_tf32_plain``,
``flash_attention_bwd_tf32_plain``) against the JAX package's kernel, and
run the kernels' source itself compiled with g++ against an emulation of
the CUDA features it uses (``tests/_torch_cuda_emu.py``); on the card,
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` hold each
kernel against the plain versions here.

Counts of launches in this process, one a launch of its kernel:
``flash_attention_fwd.launches`` (split-TF32 forward), ``.tc_launches``
(tensor-core forward); ``flash_attention_bwd_dq.launches`` (split-TF32
dQ), ``.tc_launches`` (tensor-core dQ); ``flash_attention_bwd_dkv.launches``
(split-TF32 dK/dV), ``.tf32_reduce_launches`` (its group sum, G > 1),
``.tc_launches`` (tensor-core dK/dV) and ``.reduce_launches`` (its group
sum).  Each of the three also has ``.by_head_dim``: its launches by head
dim and instantiation, ``(kind, d, D)`` with kind ``"tc"`` (bf16) or
``"tf32"`` (f32); a dK/dV launch and its group sum count once there.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, budget
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# C entry point -> (pointer operands, strided operands)
_SYMBOLS = {"flash_attention_fwd": (5, 4), "flash_attention_bwd_dq": (7, 5),
            "flash_attention_bwd_dkv": (10, 6),
            "flash_attention_fwd_tc": (5, 4),
            "flash_attention_bwd_dq_tc": (7, 5),
            "flash_attention_bwd_dkv_tc": (10, 6)}


def _fn(symbol: str):
    fn = getattr(_build.load("flash_attention"), symbol)
    if fn.argtypes is None:
        pointers, strided = _SYMBOLS[symbol]
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * (3 * strided)
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _call(symbol: str, pointers, sizes, strided, sc, causal, dtype) -> None:
    """Launch ``symbol`` on the current stream of the operands' card and
    raise if CUDA refused the launch."""
    dev = strided[0].device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: the kernels take CUDA tensors, "
                         f"not {dev}")
    fn = _fn(symbol)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(0 if t is None else t.data_ptr() for t in pointers),
                 *sizes,
                 *(st for t in strided for st in t.stride()[:3]),
                 float(sc), int(causal), DTYPES[dtype], stream)
    _build.check(err, "flash_attention")


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    _build.check_operand("flash_attention", name, t, dtype, shape, device,
                         rows_strided=True)


def _check_qkv(q, k, v, smem_bytes, *rows) -> Tuple[int, ...]:
    """Check q, k, v and the q-shaped ``rows`` operands, that the kernels
    take their head dim, and that ``smem_bytes(d)`` fits a block; returns
    (B, H, KV, T, S, d)."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not one of "
                         f"{list(DTYPES)}")
    _check(q, "q", q.dtype, (b, h, t, d), dev)
    _check(k, "k", q.dtype, (b, kv, s, d), dev)
    _check(v, "v", q.dtype, (b, kv, s, d), dev)
    for name, x in rows:
        _check(x, name, q.dtype, (b, h, t, d), dev)
    fault = budget.flash_head_dim_fault(d, q.element_size())
    if fault is not None:
        raise ValueError(f"flash_attention: {fault}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} heads over {kv} kv heads")
    if not budget.smem_fits(smem_bytes(d)):
        raise ValueError("flash_attention: chunks bust shared memory")
    return b, h, kv, t, s, d


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its address and (b, h, t) strides are 16-byte
    multiples, as the kernels' 16-byte copies need, else a contiguous
    copy."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(st % step == 0
                                      for st in t.stride()[:3]):
        return t
    return t.contiguous()


def _check_stats(lse, delta, shape, dev) -> None:
    for name, x in (("lse", lse), ("delta", delta)):
        _build.check_operand("flash_attention", name, x, torch.float32,
                             shape, dev)


def _launch(q, k, v, sc, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    tc = q.dtype == torch.bfloat16
    b, h, kv, t, s, d = _check_qkv(
        q, k, v, budget.flash_tc_smem_bytes if tc
        else budget.flash_fwd_tf32_smem_bytes)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # O in q's memory layout: a (B, T, H, d) buffer seen as (B, H, T, d)
    # when q is a transposed view of the model's tensor.
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _call("flash_attention_fwd_tc" if tc else "flash_attention_fwd",
          (q, k, v, out, lse), (b, h, kv, t, s, d), (q, k, v, out), sc,
          causal, q.dtype)
    if tc:
        flash_attention_fwd.tc_launches += 1
    else:
        flash_attention_fwd.launches += 1
    _count_head_dim(flash_attention_fwd, "tc" if tc else "tf32", d)
    return out, lse


def _count_head_dim(wrapper, kind: str, d: int) -> None:
    key = (kind, d, budget.flash_head_dim(d))
    wrapper.by_head_dim[key] = wrapper.by_head_dim.get(key, 0) + 1


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sc: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: q (B, H, T, d), k/v (B, KV, S, d), f32 or bf16 ->
    O (B, H, T, d) in q's dtype and lse (B, H, T) f32.  ``meta`` tensors
    (the dry run) get empty ``meta`` outputs of those shapes: nothing is
    launched or computed."""
    if q.device.type == "cuda":
        return _launch(q, k, v, sc, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sc=sc, causal=causal)
    if q.device.type == "meta":
        return (torch.empty_like(q),
                torch.empty(q.shape[:3], dtype=torch.float32, device="meta"))
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0
# launches by head dim: (kind, d, its instantiation D) -> count
flash_attention_fwd.by_head_dim = {}


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, *, sc: float, causal: bool
                           ) -> torch.Tensor:
    """The dQ kernel: q, dO (B, H, T, d), k/v (B, KV, S, d), lse and delta
    (B, H, T) f32, all on one card -> dQ (B, H, T, d) in q's dtype and
    memory layout.  bf16 operands run the tensor-core kernel, f32 operands
    the split-TF32 kernel."""
    tc = q.dtype == torch.bfloat16
    b, h, kv, t, s, d = _check_qkv(
        q, k, v, budget.flash_bwd_dq_tc_smem_bytes if tc
        else budget.flash_bwd_dq_smem_bytes, ("do", do))
    _check_stats(lse, delta, (b, h, t), q.device)
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _call("flash_attention_bwd_dq_tc" if tc else "flash_attention_bwd_dq",
          (q, k, v, do, lse, delta, dq), (b, h, kv, t, s, d),
          (q, k, v, do, dq), sc, causal, q.dtype)
    if tc:
        flash_attention_bwd_dq.tc_launches += 1
    else:
        flash_attention_bwd_dq.launches += 1
    _count_head_dim(flash_attention_bwd_dq, "tc" if tc else "tf32", d)
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            sc: float, causal: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: the dQ kernel's operands -> dK, dV (B, KV, S, d)
    in the dtypes and memory layouts of k and v, each summed over the
    G query heads of its kv head.  bf16 operands run the tensor-core kernel
    and its group sum (two launches); f32 operands the split-TF32 kernel,
    and its group sum when G > 1."""
    tc = q.dtype == torch.bfloat16
    b, h, kv, t, s, d = _check_qkv(
        q, k, v, budget.flash_bwd_dkv_tc_smem_bytes if tc
        else budget.flash_bwd_dkv_smem_bytes, ("do", do))
    _check_stats(lse, delta, (b, h, t), q.device)
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    # f32 sums per query head, (B, H, S, d) each, summed by the reduce
    # kernel into dK and dV; none where the f32 kernel writes dK and dV
    # itself (each kv head has one query head), which the launcher follows
    grouped = tc or h != kv
    dk_part = dv_part = None
    if grouped:
        dk_part = torch.empty((b, h, s, d), dtype=torch.float32,
                              device=q.device)
        dv_part = torch.empty_like(dk_part)
    _call("flash_attention_bwd_dkv_tc" if tc else "flash_attention_bwd_dkv",
          (q, k, v, do, lse, delta, dk, dv, dk_part, dv_part),
          (b, h, kv, t, s, d), (q, k, v, do, dk, dv), sc, causal, q.dtype)
    if tc:
        flash_attention_bwd_dkv.tc_launches += 1
        flash_attention_bwd_dkv.reduce_launches += 1
    else:
        flash_attention_bwd_dkv.launches += 1
        flash_attention_bwd_dkv.tf32_reduce_launches += grouped
    _count_head_dim(flash_attention_bwd_dkv, "tc" if tc else "tf32", d)
    return dk, dv


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32: (B, H, T, d) -> (B, H, T)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, sc: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward from the forward's residuals: q, O, dO
    (B, H, T, d), k/v (B, KV, S, d), lse (B, H, T) f32 -> dQ, dK, dV in
    the dtypes of q, k and v (empty ``meta`` ones for ``meta`` tensors, as
    the forward's)."""
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cuda":
        delta = bwd_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, sc=sc,
                                    causal=causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, sc=sc,
                                         causal=causal)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, sc=sc,
                                         causal=causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0
flash_attention_bwd_dq.by_head_dim = {}
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tf32_reduce_launches = 0
flash_attention_bwd_dkv.tc_launches = 0
flash_attention_bwd_dkv.reduce_launches = 0
flash_attention_bwd_dkv.by_head_dim = {}
