"""Hopper limits the port's kernels check their schedules against.

Port of ``repro/kernels/budget.py``.  The TPU budgets (``VMEM_BUDGET`` for
the staged blocks, ``SMEM_BUDGET`` for the scalar-prefetched indices) have
no counterpart here: the CUDA kernels read their indices and inputs from
device memory and stage a chunk at a time in shared memory: the ELL conv an
input slab of a channel chunk and each row's window of nonzeros, the BCSR
conv the group's tiles at one block column (both halves of their split),
flash attention a query chunk and a kv chunk (the backward kernels a query
chunk with its dO rows and a kv chunk); the BCSR matmul's ``rows`` schedule
stages nothing but its 4 warps' partial sums, its ``wgmma`` schedule a ring
of x chunks and the kept tiles that fall in them.  What bounds a schedule
on an H100 is a block's shared memory, and how many blocks fill the card's
132 SMs (NVIDIA H100 data sheet and the CUDA programming guide, compute
capability 9.0).
"""
from __future__ import annotations

import functools
from typing import Optional

# Shared memory one block may use after the opt-in
# (cudaFuncAttributeMaxDynamicSharedMemorySize): 227 KB of the SM's 256 KB.
SMEM_MAX = 232_448
# Without the opt-in a block gets at most 48 KB of dynamic shared memory.
SMEM_DEFAULT = 48 * 1024
WARP = 32
# Streaming multiprocessors of an H100 SXM: the conv schedules pick tiles
# small enough to give each at least one block.
SMS = 132

# ELL conv (csrc/sparse_conv.cu): 256 threads a block, TM output channels
# (TM/8 a warp) by 32*PX pixels (PX a lane); the (TM, PX) pairs the source
# instantiates, widest pixel tiles first.  The slab stages of a block (one
# when blocking, two when pipelined: the input slab of a channel chunk
# each) take about ELL_SLAB_BYTES together, so that four blocks share an
# SM either way: the ELL ablation found the blocks an SM worth more than a
# deeper copy (PERF.md, Findings).
ELL_TILES = ((32, 4), (16, 4), (8, 8), (8, 4), (32, 2), (16, 2), (8, 2),
             (32, 1), (16, 1), (8, 1))
ELL_SLAB_BYTES = 48 * 1024
# The schedule takes the first of ELL_TILES whose blocks number at least
# this (about 1.5 an SM); the order and the count are the ELL ablation's
# (PERF.md, Findings: the fastest tile at each of the five main-path
# layers).
ELL_MIN_BLOCKS = 3 * SMS // 2
# The unstaged 1x1 kernel's order: its rows share their inputs through L1,
# where narrow channel tiles did best (ResNet-50's res4b/1x1b: (8, 4) 0.057
# ms against (32, 4) 0.072 on an H100 SXM).
ELL_1X1_TILES = ((8, 4), (8, 8), (16, 4), (8, 2), (16, 2), (32, 4), (32, 2),
                 (8, 1), (16, 1), (32, 1))
# BCSR conv (csrc/bsr_conv.cu): a warpgroup of 128 threads a 64-pixel tile,
# 1 or 2 a block, over N output channels (a group of N/bm block-rows); the
# (N, warpgroups) pairs it instantiates.  The TF32 operands
# of N = 64 fill 128 KB of shared memory; N = 128 would not fit.
BSR_CONV_TILES = ((64, 2), (32, 2), (64, 1), (32, 1))
# ... the first of them whose blocks number at least this (half the SMs:
# a block of two warpgroups holds an SM's tensor cores busier than two
# blocks of one); again the ablation's order (PERF.md, Findings).
BSR_CONV_MIN_BLOCKS = SMS // 2

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


@functools.lru_cache(maxsize=1024)
def ell_slab_rows(n: int, e: int, f: int, hs: int, st: int, rt: int,
                  tp: int) -> int:
    """Padded input rows the ELL conv's largest pixel tile reads: a tile is
    ``tp`` consecutive pixels of the flat (n, e, f) order (``f`` the
    kernel's pixels a row: the slab's width at stride 1), and reads the
    rows of its first window through its last, across images (``hs`` rows
    an image in the slab's coordinates, ``st`` rows an output row, ``rt``
    filter rows)."""
    ef = e * f
    total = n * ef
    best = 0
    for q0 in range(0, total, tp):
        q1 = min(q0 + tp, total) - 1
        ga = (q0 // ef) * hs + (q0 % ef) // f * st
        gb = (q1 // ef) * hs + (q1 % ef) // f * st + rt - 1
        best = max(best, gb - ga + 1)
    return best


def ell_stage_bytes(cc: int, rows: int, ws: int, s: int) -> int:
    """One stage of the ELL conv: the f32 input slab of ``cc`` channels x
    ``rows`` x ``ws`` and ``s`` words of slack (a dropped pixel's reads),
    padded to 16 bytes."""
    return -(-(cc * rows * ws + s) // 4) * 16


def ell_smem_bytes(tm: int, cc: int, c: int, rows: int, ws: int, s: int,
                   pipeline: bool) -> int:
    """Dynamic shared memory of one ELL block: two slab stages when
    pipelined, one when blocking, the int32 source offset of each slab row,
    and the ``tm`` rows' run bounds for each of the C/``cc`` chunks."""
    return ((2 if pipeline else 1) * ell_stage_bytes(cc, rows, ws, s)
            + cc * rows * 4 + tm * (-(-c // cc) + 1) * 4)


def bsr_conv_smem_bytes(bm: int, bn: int, n_tile: int, kbc: int) -> int:
    """Dynamic shared memory of one BCSR conv block: two stages of the TF32
    hi and lo B operands (``n_tile`` x ``bn``), three slots of ``bn`` int32
    column offsets, the (n_tile/bm x ``kbc``) table of kept tiles and the
    ``kbc`` live block columns."""
    return 2 * 2 * n_tile * bn * 4 + 4 * (3 * bn + (n_tile // bm + 1) * kbc)


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
