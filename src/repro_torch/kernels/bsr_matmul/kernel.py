"""Launcher of the CUDA BCSR matmul kernel (``csrc/bsr_matmul.cu``).

Replaces ``bsr_matmul_pallas`` (``repro/kernels/bsr_matmul/kernel.py``).
``bsr_matmul_kernel`` takes the kernel's operands; for CUDA tensors it
launches the kernel on the current stream, for CPU tensors it runs the plain
version (``ref.py``), and for anything else it raises.  A launch that CUDA
refuses raises too.

The source has two schedules: ``rows`` (SIMT, f32 or bf16, for few rows:
decode) and ``wgmma`` (bf16 on the tensor cores, for many rows: prefill;
x staged once per group of 16 block-rows).  ``schedule()`` picks one from
the row count and the dtype.  The kernel writes y in ``out_dtype`` (f32 or
bf16) from its f32 sums, one rounding.

The ``wgmma`` schedule needs each block-row's kept block columns strictly
ascending (what ``bcsr_from_dense`` builds); its launcher checks that on
the card once per bank (``_build.check_once``: one read-back per weight,
none per call) and raises otherwise.

``bsr_matmul_kernel.launches`` counts the kernel's launches in this process
(both schedules), ``bsr_matmul_kernel.wgmma_launches`` those of the
``wgmma`` schedule.  Only the CUDA branch adds to them, once per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse_format import block_column_fault
from repro_torch.kernels import _build, budget
from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

_SYMBOL = "bsr_matmul"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SCHEDULES = {"rows": 0, "wgmma": 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_matmul")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def schedule(rows: int, dtype: torch.dtype) -> str:
    """``wgmma`` for bf16 inputs above ``budget.BSR_MATMUL_ROWS_MAX`` rows,
    ``rows`` otherwise (f32 has no tensor-core path that keeps f32)."""
    if dtype == torch.bfloat16 and rows > budget.BSR_MATMUL_ROWS_MAX:
        return "wgmma"
    return "rows"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    _build.check_operand("bsr_matmul", name, t, dtype, shape, device)
    if t.data_ptr() % 16:
        raise ValueError(f"bsr_matmul: {name} is not 16-byte aligned")


def _walkable(blockcol, nblocks, ncols):
    """The ``wgmma`` schedule walks each block-row's tiles with one pointer
    in step with x's column chunks: a tile out of order would be skipped and
    a repeated column would land in the slot of its twin, both without an
    error.  So it refuses such a bank (``rows`` sums any order)."""
    fault = block_column_fault(blockcol, nblocks, ncols, ascending=True)
    if fault is not None:
        raise ValueError(f"bsr_matmul: the wgmma schedule cannot walk this "
                         f"bank: {fault}")


def _launch(x, blocks, blockcol, nblocks, out_dtype) -> torch.Tensor:
    b, n = x.shape
    gm, kb_dim, bm, bn = blocks.shape
    dev = x.device
    for what, dt in (("dtype", x.dtype), ("out_dtype", out_dtype)):
        if dt not in DTYPES:
            raise ValueError(f"bsr_matmul: {what} {dt} not one of "
                             f"{list(DTYPES)}")
    _check(x, "x", x.dtype, (b, n), dev)
    _check(blocks, "blocks", x.dtype, (gm, kb_dim, bm, bn), dev)
    _check(blockcol, "blockcol", torch.int32, (gm, kb_dim), dev)
    _check(nblocks, "nblocks", torch.int32, (gm,), dev)
    sched = schedule(b, x.dtype)
    reason = budget.bsr_matmul_unsupported(bm, bn, n, sched)
    if reason is not None:
        raise ValueError(f"bsr_matmul: {reason}")
    if b * max(n, gm * bm) >= 2**31:
        raise ValueError("bsr_matmul: x or y exceeds int32 row offsets")
    if sched == "wgmma":
        _build.check_once("bsr_matmul_wgmma", (blockcol, nblocks),
                          lambda: _walkable(blockcol, nblocks, n // bn))
    out = torch.empty((b, gm * bm), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), _SYMBOL)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), blocks.data_ptr(), blockcol.data_ptr(),
                 nblocks.data_ptr(), out.data_ptr(), b, n, gm, kb_dim, bm, bn,
                 DTYPES[x.dtype], DTYPES[out_dtype], SCHEDULES[sched], stream)
    _build.check(err, "bsr_matmul")
    bsr_matmul_kernel.launches += 1
    if sched == "wgmma":
        bsr_matmul_kernel.wgmma_launches += 1
    return out


def bsr_matmul_kernel(x: torch.Tensor, blocks: torch.Tensor,
                      blockcol: torch.Tensor, nblocks: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """y = x @ W.T for BCSR W, f32 accumulate.

    x (B, N) f32 or bf16 with N % bn == 0; blocks (gm, KB, bm, bn) of x's
    dtype; blockcol (gm, KB) int32, strictly ascending within a row up to
    its nblocks for the ``wgmma`` schedule (checked once per bank);
    nblocks (gm,) int32.  Returns (B, gm*bm) in ``out_dtype``
    (f32 or bf16): the f32 sums rounded once.
    """
    if x.device.type == "cuda":
        return _launch(x, blocks, blockcol, nblocks, out_dtype)
    if x.device.type == "cpu":
        return bsr_matmul_plain(x, blocks, blockcol, nblocks).to(out_dtype)
    raise ValueError(f"bsr_matmul: no kernel for device {x.device}")


bsr_matmul_kernel.launches = 0
bsr_matmul_kernel.wgmma_launches = 0
