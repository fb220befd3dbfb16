"""Hopper limits the two conv kernels check their schedules against.

Port of ``repro/kernels/budget.py``.  The TPU budgets (``VMEM_BUDGET`` for
the staged blocks, ``SMEM_BUDGET`` for the scalar-prefetched indices) have
no counterpart here: the CUDA kernels read their indices and inputs from
device memory and stage only a slab of nonzeros (ELL) or one weight tile
(BCSR) in shared memory.  What bounds a schedule on an H100 is a block's
shared memory and its thread count (NVIDIA H100 data sheet and the CUDA
programming guide, compute capability 9.0).
"""
from __future__ import annotations

# Shared memory one block may use after the opt-in
# (cudaFuncAttributeMaxDynamicSharedMemorySize): 227 KB of the SM's 256 KB.
SMEM_MAX = 232_448
# Without the opt-in a block gets at most 48 KB of dynamic shared memory.
SMEM_DEFAULT = 48 * 1024
WARP = 32
# Both kernels are compiled with __launch_bounds__(256): one thread per output
# pixel, at most 256 pixels a block, so that up to 16 f32 sums (the tallest
# BCSR block) stay in registers.
MAX_THREADS_PER_BLOCK = 256


def ell_smem_bytes(tm: int, ks: int) -> int:
    """Shared memory of one ELL block: a slab of ``ks`` nonzeros for each of
    its ``tm`` rows, one int32 stretched offset and one f32 value each, plus
    the rows' int32 nnz."""
    return tm * ks * 8 + tm * 4


def bsr_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one BCSR block: the (bm, bn) f32 weight tile plus
    the bn int32 input offsets of its decoded columns."""
    return bm * bn * 4 + bn * 4


def smem_fits(nbytes: int) -> bool:
    return nbytes <= SMEM_MAX


def threads_fit(threads: int) -> bool:
    return 0 < threads <= MAX_THREADS_PER_BLOCK and threads % WARP == 0
