"""Launcher of the CUDA BCSR matmul kernel (``csrc/bsr_matmul.cu``).

Replaces ``bsr_matmul_pallas`` (``repro/kernels/bsr_matmul/kernel.py``).
``bsr_matmul_kernel`` takes the kernel's operands; for CUDA tensors it
launches the kernel on the current stream, for CPU tensors it runs the plain
version (``ref.py``), for ``meta`` tensors (the dry run) it returns an empty
``meta`` output of the result's shape, and for anything else it raises.  A
launch that CUDA refuses raises too.  The three branches are also one
registered op, ``torch.ops.repro_torch.bsr_matmul`` (its ``meta`` branch
the op's fake implementation), with a flop formula: 2 x rows x the bank's
tiles x bm x bn.  Under a dispatch mode (the dry run's counters,
``launch/costs.py``) the wrapper calls the op, so the mode sees the kernel
as one op that reads x and the bank and writes y, on ``meta`` as on a
device, and not the plain version's ops inside it; otherwise it calls the
branch itself, sparing the decode loop the dispatcher's host time a call.

The source has two schedules: ``rows`` (f32 or bf16, for few rows: decode;
a weight-streaming kernel) and ``wgmma`` (bf16 on the tensor cores, for
many rows: prefill; x staged once per group of 16 block-rows).
``schedule()`` picks one from the row count and the dtype.  The kernel
writes y in ``out_dtype`` (f32 or bf16) from its f32 sums, one rounding.

Blocks: any (bm, bn) with both sides multiples of 16
(``budget.bsr_matmul_native``); ``ops.bsr_matmul`` re-tiles any other bank
first (``ref.retile_bcsr``), so a bank that reaches this launcher with
another block raises.  Both schedules read a (bm, bn) bank as gm bm / 16
sub-rows of (16, bn) pieces (``ref``), so a taller tile costs no copy.

The ``rows`` schedule runs from a work list over the sub-rows
(``ref.rows_units`` on ``ref.subrow_counts``: each sub-row's run of kept
pieces cut into ``budget.bsr_matmul_rows_cluster`` units of about equal
size, the units of a sub-row one thread-block cluster where there are
several; ``ref.rows_cols``: each unit's block columns), built once per
bank (``_build.cached``: one read-back of the bank's indices per weight,
none per call).  A cluster adds its units' sums on chip: no workspace, no
atomics, one launch.

The ``wgmma`` schedule needs each block-row's kept block columns strictly
ascending (what ``bcsr_from_dense`` builds); its launcher checks that on
the card once per bank (``_build.check_once``: one read-back per weight,
none per call) and raises otherwise.

``bsr_matmul_kernel.launches`` counts the kernel's launches in this process
(both schedules), ``bsr_matmul_kernel.wgmma_launches`` those of the
``wgmma`` schedule, ``bsr_matmul_kernel.by_block`` those by (schedule, bm,
bn).  Only the CUDA branch adds to them, once per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.sparse_format import block_column_fault
from repro_torch.kernels import _build, budget
from repro_torch.kernels.bsr_matmul.ref import (bsr_matmul_plain, rows_cols,
                                                rows_units, subrow_counts)

_SYMBOL = "bsr_matmul"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SCHEDULES = {"rows": 0, "wgmma": 1}


# the C entry point's parameters: x, blocks, blockcol, nblocks, y, units,
# cols; 15 sizes and codes; the stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_matmul")
    fn = getattr(lib, _SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def schedule(rows: int, dtype: torch.dtype) -> str:
    """``wgmma`` for bf16 inputs above ``budget.BSR_MATMUL_ROWS_MAX`` rows,
    ``rows`` otherwise (f32 has no tensor-core path that keeps f32)."""
    if dtype == torch.bfloat16 and rows > budget.BSR_MATMUL_ROWS_MAX:
        return "wgmma"
    return "rows"


@functools.lru_cache(maxsize=1024)
def _shape_fault(dtype, out_dtype, b, n, gm, bm, bn, sched):
    """Why the kernel cannot take a launch of this shape, or None: the
    checks that depend on the shape alone, made once a shape (a decode
    step launches the same few shapes hundreds of times)."""
    for what, dt in (("dtype", dtype), ("out_dtype", out_dtype)):
        if dt not in DTYPES:
            return f"{what} {dt} not one of {list(DTYPES)}"
    reason = budget.bsr_matmul_unsupported(bm, bn, n, sched)
    if reason is not None:
        return reason
    if b * max(n, gm * bm) >= 2**31:
        return "x or y exceeds int32 row offsets"
    return None


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    _build.check_operand("bsr_matmul", name, t, dtype, shape, device)
    if t.data_ptr() % 16:
        raise ValueError(f"bsr_matmul: {name} is not 16-byte aligned")


def _rows_entry(blockcol: torch.Tensor, nblocks: torch.Tensor, bm: int,
                bn: int, itemsize: int):
    """(units, cols, cluster, launch) for a bank, made once per bank, tile
    geometry and sizing (one read-back of the bank's indices); units run
    over the bank's sub-rows; launch holds the C entry point's rows
    arguments that depend on the bank alone: the work list's pointers, its
    units, the stage's pieces, the cluster and the units' most tiles."""
    def make():
        counts = nblocks.tolist()
        cluster = budget.bsr_matmul_rows_cluster(len(counts), sum(counts),
                                                 bm, bn, itemsize)
        units = rows_units(subrow_counts(counts, bm), cluster)
        cols = rows_cols(units, blockcol, bm).to(nblocks.device)
        units = units.to(nblocks.device)
        launch = (units.data_ptr(), cols.data_ptr(), units.shape[0],
                  budget.bsr_matmul_rows_stage_tiles(bn, itemsize),
                  cluster, cols.shape[1])
        return units, cols, cluster, launch
    sizing = (budget.BSR_MATMUL_ROWS_UNITS_PER_SM,
              budget.BSR_MATMUL_ROWS_CLUSTER_MAX,
              budget.BSR_MATMUL_ROWS_UNIT_MIN_BYTES)
    return _build.cached("bsr_matmul_rows", (blockcol, nblocks),
                         (bm, bn, itemsize) + sizing, make)


def rows_work(blockcol: torch.Tensor, nblocks: torch.Tensor, bm: int,
              bn: int, itemsize: int):
    """The ``rows`` schedule's work list for a bank: (units, cols, cluster)
    on the bank's device, ``ref.rows_units`` over the sub-rows and
    ``ref.rows_cols`` with ``budget.bsr_matmul_rows_cluster``."""
    return _rows_entry(blockcol, nblocks, bm, bn, itemsize)[:3]


def _walkable(blockcol, nblocks, ncols):
    """The ``wgmma`` schedule walks each block-row's tiles with one pointer
    in step with x's column chunks: a tile out of order would be skipped and
    a repeated column would land in the slot of its twin, both without an
    error.  So it refuses such a bank (``rows`` sums any order)."""
    fault = block_column_fault(blockcol, nblocks, ncols, ascending=True)
    if fault is not None:
        raise ValueError(f"bsr_matmul: the wgmma schedule cannot walk this "
                         f"bank: {fault}")


def _launch(x, blocks, blockcol, nblocks, out_dtype,
            sched=None) -> torch.Tensor:
    """Launch the kernel; ``sched`` forces a schedule (the ablation's
    crossover sweep), else ``schedule()`` picks it."""
    b, n = x.shape
    gm, kb_dim, bm, bn = blocks.shape
    dev = x.device
    sched = schedule(b, x.dtype) if sched is None else sched
    fault = _shape_fault(x.dtype, out_dtype, b, n, gm, bm, bn, sched)
    if fault is not None:
        raise ValueError(f"bsr_matmul: {fault}")
    _check(x, "x", x.dtype, (b, n), dev)
    _check(blocks, "blocks", x.dtype, (gm, kb_dim, bm, bn), dev)
    _check(blockcol, "blockcol", torch.int32, (gm, kb_dim), dev)
    _check(nblocks, "nblocks", torch.int32, (gm,), dev)
    out = torch.empty((b, gm * bm), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_lib(), _SYMBOL)
    if sched == "wgmma":
        _build.check_once("bsr_matmul_wgmma", (blockcol, nblocks),
                          lambda: _walkable(blockcol, nblocks, n // bn))
        work, rows_pass = (None, None, 0, 0, 0, 0), 0
    else:
        size = x.element_size()
        work = _rows_entry(blockcol, nblocks, bm, bn, size)[3]
        rows_pass = budget.bsr_matmul_rows_pass(b, size)
    units, cols, nunits, stage_tiles, cluster, maxt = work
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), blocks.data_ptr(), blockcol.data_ptr(),
                 nblocks.data_ptr(), out.data_ptr(), units, cols, b, n, gm,
                 kb_dim, bm, bn, nunits, stage_tiles, cluster, maxt,
                 budget.BSR_MATMUL_ROWS_BLOCKS_PER_SM, rows_pass,
                 DTYPES[x.dtype], DTYPES[out_dtype], SCHEDULES[sched], stream)
    _build.check(err, "bsr_matmul")
    bsr_matmul_kernel.launches += 1
    if sched == "wgmma":
        bsr_matmul_kernel.wgmma_launches += 1
    by_block = bsr_matmul_kernel.by_block
    by_block[sched, bm, bn] = by_block.get((sched, bm, bn), 0) + 1
    return out


def bsr_matmul_kernel(x: torch.Tensor, blocks: torch.Tensor,
                      blockcol: torch.Tensor, nblocks: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """y = x @ W.T for BCSR W, f32 accumulate.

    x (B, N) f32 or bf16 with N % bn == 0; blocks (gm, KB, bm, bn) of x's
    dtype, bm and bn multiples of 16 (a CUDA tensor's launch raises
    otherwise; the CPU's plain version takes any block); blockcol (gm, KB) int32, in any order for the ``rows``
    schedule, strictly ascending within a row up to its nblocks for the
    ``wgmma`` schedule (checked once per bank); nblocks (gm,) int32.
    Tiles past a row's nblocks are never read.  Returns (B, gm*bm) in
    ``out_dtype`` (f32 or bf16): the f32 sums rounded once, the same bits
    on every launch.
    """
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"bsr_matmul: no kernel for device {x.device}")
    if _get_current_dispatch_mode() is not None:
        return torch.ops.repro_torch.bsr_matmul(x, blocks, blockcol,
                                                nblocks, out_dtype)
    if x.device.type == "meta":
        return _empty(x, blocks, blockcol, nblocks, out_dtype)
    return _run(x, blocks, blockcol, nblocks, out_dtype)


def _run(x: torch.Tensor, blocks: torch.Tensor, blockcol: torch.Tensor,
         nblocks: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x, blocks, blockcol, nblocks, out_dtype)
    return bsr_matmul_plain(x, blocks, blockcol, nblocks).to(out_dtype)


def _empty(x, blocks, blockcol, nblocks, out_dtype):
    return x.new_empty((x.shape[0], blocks.shape[0] * blocks.shape[2]),
                       dtype=out_dtype)


_op = torch.library.custom_op("repro_torch::bsr_matmul", _run,
                              mutates_args=())
_op.register_fake(_empty)


@register_flop_formula(torch.ops.repro_torch.bsr_matmul)
def _flops(x_shape, blocks_shape, *args, out_shape=None, **kwargs) -> int:
    """2 x rows x every tile of the bank x bm x bn: on ``meta`` there are
    no ``nblocks`` values, and the dry run's banks keep as many tiles in
    every block-row as the bank holds."""
    gm, kb, bm, bn = blocks_shape
    return 2 * x_shape[0] * gm * kb * bm * bn


bsr_matmul_kernel.launches = 0
bsr_matmul_kernel.wgmma_launches = 0
# launches by (schedule, bm, bn) -> count
bsr_matmul_kernel.by_block = {}
