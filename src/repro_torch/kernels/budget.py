"""Hopper limits the port's kernels check their schedules against.

Port of ``repro/kernels/budget.py``.  The TPU budgets (``VMEM_BUDGET`` for
the staged blocks, ``SMEM_BUDGET`` for the scalar-prefetched indices) have
no counterpart here: the CUDA kernels read their indices and inputs from
device memory and stage only a slab of nonzeros (ELL conv), one weight tile
(BCSR conv), or a query chunk and a kv chunk (flash attention) in shared
memory (the flash backward kernels a query chunk with its dO rows and a kv
chunk); the BCSR matmul's ``rows`` schedule stages nothing but its 4 warps'
partial sums, its ``wgmma`` schedule a ring of x chunks and the kept tiles
that fall in them.  What
bounds a schedule on an H100 is a block's shared memory and its thread
count (NVIDIA H100 data sheet and the CUDA programming guide, compute
capability 9.0).
"""
from __future__ import annotations

from typing import Optional

# Shared memory one block may use after the opt-in
# (cudaFuncAttributeMaxDynamicSharedMemorySize): 227 KB of the SM's 256 KB.
SMEM_MAX = 232_448
# Without the opt-in a block gets at most 48 KB of dynamic shared memory.
SMEM_DEFAULT = 48 * 1024
WARP = 32
# Both conv kernels are compiled with __launch_bounds__(256): one thread per
# output pixel, at most 256 pixels a block, so that up to 16 f32 sums (the
# tallest BCSR block) stay in registers.
MAX_THREADS_PER_BLOCK = 256

# BCSR matmul (csrc/bsr_matmul.cu): the block height it instantiates (the
# (16, 16) tiles ``sparsify_params`` builds), and the largest row count the
# SIMT ``rows`` schedule takes on bf16 inputs before the tensor-core
# ``wgmma`` schedule does.  The crossover is not measured: the paths that
# exist give 4 rows (decode) or thousands (prefill), far on either side of
# it.
BSR_MATMUL_BM = (16,)
BSR_MATMUL_ROWS_MAX = 32
# rows: 4 warps x 8 rows x BM f32 partial sums, reduced across warps.
BSR_MATMUL_ROWS_WARPS = 4
BSR_MATMUL_ROWS_PER_BLOCK = 8
# wgmma: a block of two warpgroups owns 128 rows of x and a group of 16
# block-rows, and walks x in chunks of 128 columns: a ring of 3 x stages
# and one of 2 stages of the group's tiles.
BSR_MATMUL_WGMMA_ROWS = 128
BSR_MATMUL_WGMMA_GROUP = 16
BSR_MATMUL_WGMMA_CHUNK = 128
BSR_MATMUL_WGMMA_X_STAGES = 3
BSR_MATMUL_WGMMA_TILE_STAGES = 2

# Flash attention (csrc/flash_attention.cu): 64 query rows and 32 keys a
# step, head dimensions it instantiates.
FLASH_BQ = 64
FLASH_BK = 32
FLASH_HEAD_DIMS = (16, 32, 64, 128)
# Its tensor-core kernels (bf16): 64-row tiles (wgmma's M) and 64-key
# chunks; a warpgroup of 128 threads a 64-row tile.  The forward runs
# FLASH_TC_FWD_WARPGROUPS of them a block over one ring of key and value
# stages; dK/dV a ring of query, dO, lse and delta stages, and its two
# warpgroups pass p through shared memory, one f32 slot a thread for each
# of its 32 accumulator elements.
FLASH_TC_BQ = 64
FLASH_TC_BK = 64
FLASH_TC_WARPGROUP = 128
FLASH_TC_FWD_WARPGROUPS = 2
FLASH_TC_FWD_STAGES = 2
FLASH_TC_DKV_STAGES = 2
# dQ: the forward's block (two warpgroups over one ring of key and value
# stages), with a dO tile beside each q tile.
FLASH_TC_DQ_WARPGROUPS = 2
FLASH_TC_DQ_STAGES = 2


def ell_smem_bytes(tm: int, ks: int) -> int:
    """Shared memory of one ELL block: a slab of ``ks`` nonzeros for each of
    its ``tm`` rows, one int32 stretched offset and one f32 value each, plus
    the rows' int32 nnz."""
    return tm * ks * 8 + tm * 4


def bsr_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one BCSR conv block: the (bm, bn) f32 weight tile
    plus the bn int32 input offsets of its decoded columns."""
    return bm * bn * 4 + bn * 4


def bsr_matmul_smem_bytes(bm: int) -> int:
    """Static shared memory of one ``rows`` block of the BCSR matmul: the
    warps' f32 partial sums."""
    return BSR_MATMUL_ROWS_WARPS * BSR_MATMUL_ROWS_PER_BLOCK * bm * 4


def bsr_matmul_wgmma_smem_bytes() -> int:
    """Dynamic shared memory of one ``wgmma`` block: each x stage the bf16
    x chunk of its rows; each tile stage a (16, 16) bf16 slot for every
    16-column block of the chunk and block-row of the group (a kept tile
    fills ``bn / 16`` of them) and a 32-bit mask of filled slots a
    block-row."""
    x_chunk = BSR_MATMUL_WGMMA_ROWS * BSR_MATMUL_WGMMA_CHUNK * 2
    slots = (BSR_MATMUL_WGMMA_GROUP * (BSR_MATMUL_WGMMA_CHUNK // 16)
             * 16 * 16 * 2)
    return (BSR_MATMUL_WGMMA_X_STAGES * x_chunk
            + BSR_MATMUL_WGMMA_TILE_STAGES
            * (slots + 4 * BSR_MATMUL_WGMMA_GROUP))


def bsr_matmul_unsupported(bm: int, bn: int, n: int,
                           schedule: str = "rows") -> Optional[str]:
    """Why the BCSR matmul's ``schedule`` cannot take a (bm, bn) block over
    N = ``n`` columns, or None."""
    if bm not in BSR_MATMUL_BM:
        return f"block height {bm} not one of {BSR_MATMUL_BM}"
    if bn % 16:
        return f"block width {bn} not a multiple of 16"
    if n % bn:
        return f"N = {n} not a multiple of the block width {bn}"
    if schedule == "wgmma" and BSR_MATMUL_WGMMA_CHUNK % bn:
        return (f"block width {bn} does not divide the wgmma schedule's "
                f"chunk of {BSR_MATMUL_WGMMA_CHUNK} columns")
    return None


def flash_smem_bytes(d: int, bq: int = FLASH_BQ, bk: int = FLASH_BK) -> int:
    """Dynamic shared memory of one flash-attention block: the scaled query
    chunk and the key chunk as f32 rows padded by one word (no bank
    conflicts on the column walk), the value chunk, and the (bq, bk + 1)
    probabilities."""
    return 4 * (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1))


def flash_bwd_dq_smem_bytes(d: int, bq: int = FLASH_BQ,
                            bk: int = FLASH_BK) -> int:
    """Dynamic shared memory of one dQ block: the scaled query rows and their
    dO rows, the key and value chunks, all f32 rows padded by one word, the
    (bq, bk + 1) dS tile, and the rows' lse and delta."""
    return 4 * (2 * bq * (d + 1) + 2 * bk * (d + 1) + bq * (bk + 1) + 2 * bq)


def flash_bwd_dkv_smem_bytes(d: int, bq: int = FLASH_BQ,
                             bk: int = FLASH_BK) -> int:
    """Dynamic shared memory of one dK/dV block: the dQ block's, plus the
    (bq, bk + 1) probability tile beside dS."""
    return flash_bwd_dq_smem_bytes(d, bq, bk) + 4 * bq * (bk + 1)


def flash_tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core forward block: a bf16 query
    tile for each warpgroup and the stages of key and value tiles, each
    ``FLASH_TC_BQ`` x d."""
    tiles = FLASH_TC_FWD_WARPGROUPS + 2 * FLASH_TC_FWD_STAGES
    return 2 * FLASH_TC_BQ * d * tiles


def flash_bwd_dq_tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core dQ block: a bf16 query tile
    and a dO tile for each warpgroup and the stages of key and value tiles,
    each ``FLASH_TC_BQ`` x d."""
    tiles = 2 * FLASH_TC_DQ_WARPGROUPS + 2 * FLASH_TC_DQ_STAGES
    return 2 * FLASH_TC_BQ * d * tiles


def flash_bwd_dkv_tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core dK/dV block: its bf16 key
    and value tiles, the stages of query and dO tiles and of their lse and
    delta rows (f32), and the f32 p passed between its two warpgroups."""
    return (2 * FLASH_TC_BQ * d * (2 + 2 * FLASH_TC_DKV_STAGES)
            + 4 * (2 * FLASH_TC_DKV_STAGES * FLASH_TC_BQ
                   + 32 * FLASH_TC_WARPGROUP))


def smem_fits(nbytes: int) -> bool:
    return nbytes <= SMEM_MAX


def threads_fit(threads: int) -> bool:
    return 0 < threads <= MAX_THREADS_PER_BLOCK and threads % WARP == 0
