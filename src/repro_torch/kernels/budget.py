"""Hopper limits the port's kernels check their schedules against.

Port of ``repro/kernels/budget.py``.  The TPU budgets (``VMEM_BUDGET`` for
the staged blocks, ``SMEM_BUDGET`` for the scalar-prefetched indices) have
no counterpart here: the CUDA kernels read their indices and inputs from
device memory and stage a chunk at a time in shared memory: the ELL conv an
input slab of a channel chunk and each row's window of nonzeros, the BCSR
conv the group's tiles at one block column (both halves of their split),
flash attention a query chunk and a kv chunk (the backward kernels a query
chunk with its dO rows and a kv chunk); the BCSR matmul's ``rows`` schedule
a ring of its unit's kept tiles, its ``wgmma`` schedule a ring of x chunks
and the kept tiles that fall in them.  What bounds a schedule
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
# The staged kernel on a bf16 bank and bf16 activations (the paired slab
# where stride 1 allows: ops.resolve_schedule): the same tiles, 16
# channels a block first (the bf16 ablation's fastest at res4b/3x3 and
# conv2; res5a/3x3 still takes (8, 4): PERF.md, Findings).
ELL_TILES_BF16 = ((16, 4), (32, 4), (8, 8), (8, 4), (32, 2), (16, 2), (8, 2),
                  (32, 1), (16, 1), (8, 1))
# The unstaged 1x1 kernel's order: its rows share their inputs through L1,
# where narrow channel tiles did best (ResNet-50's res4b/1x1b: (8, 4) 0.057
# ms against (32, 4) 0.072 on an H100 SXM).
ELL_1X1_TILES = ((8, 4), (8, 8), (16, 4), (8, 2), (16, 2), (32, 4), (32, 2),
                 (8, 1), (16, 1), (32, 1))
# BCSR conv (csrc/bsr_conv.cu): a warpgroup of 128 threads a 64-pixel tile,
# 1 or 2 a block, over N output channels (a group of N/bm block-rows, so
# bm <= N: a (64, 128) block runs only at N = 64); the (N, warpgroups)
# pairs it instantiates.  The TF32 operands of N = 64 fill 128 KB of
# shared memory; N = 128 would not fit.
BSR_CONV_TILES = ((64, 2), (32, 2), (64, 1), (32, 1))
# On bf16 activations a stage has no lo half, so N = 128 fits too: two
# warpgroups a block first, the widest first (the bf16 ablation's order,
# PERF.md, Findings).
BSR_CONV_BF16_TILES = ((128, 2), (64, 2), (32, 2), (128, 1), (64, 1),
                       (32, 1))
# ... the first of them whose blocks number at least this (half the SMs:
# a block of two warpgroups holds an SM's tensor cores busier than two
# blocks of one); again the ablation's order (PERF.md, Findings).
BSR_CONV_MIN_BLOCKS = SMS // 2

# BCSR matmul (csrc/bsr_matmul.cu): blocks of any height and width that
# are multiples of 16 (``bsr_matmul_native``).  The kernel reads a (bm, bn)
# bank as bm / 16 sub-rows a block-row: sub-row (i, j) reads the (16, bn)
# piece j of each of block-row i's kept tiles, 16 bn contiguous elements,
# and writes outputs 16 (i bm / 16 + j) .. + 16, so every size below counts
# (16, bn) pieces.  Any other block is re-tiled once per bank by
# ``ops.bsr_matmul`` into one whose sides are the next multiples of 16,
# and a bank too wide for a stage of the ``rows`` ring (``rows_width``:
# bn about 880 and up) has its tiles cut side by side to a width that fits.
# BSR_MATMUL_ROWS_MAX is the largest row count the ``rows`` schedule takes
# on bf16 inputs before the tensor-core ``wgmma`` schedule does (f32
# inputs always take ``rows``).  Measured on an H100 (``ablate.py
# --crossover``, PERF.md): over Yi-9B's wq, wk, gate and down at 0.8 in
# (16, 16) tiles, ``rows`` takes less device time in sum at every row
# count from 8 to 2048 (wgmma's blocks of 128 rows leave most of the card
# idle below a few thousand rows), ``wgmma`` at the prefill's 8192.
BSR_MATMUL_PIECE = 16
BSR_MATMUL_ROWS_MAX = 2048
# rows: a weight-streaming schedule.  Each sub-row's run of kept pieces (one
# a kept tile, bm bn elements apart in the bank) is cut into CLUSTER units
# of about equal size, the units of a sub-row one thread-block cluster
# where CLUSTER > 1, so that a bank of few sub-rows still fills the card.
# A block's producer warp stages x's rows (where they take at most X_MAX
# bytes, bf16 passes of 8 rows) and streams its units through a ring of
# STAGES shared-memory stages of about STAGE_BYTES (1-D bulk copies on an
# mbarrier each: one a stage at bm 16, where a unit's pieces are
# contiguous, one a piece above) while WARPS consumer warps multiply; the
# cluster's first block adds its units' sums through distributed shared
# memory.
BSR_MATMUL_ROWS_WARPS = 4
BSR_MATMUL_ROWS_STAGES = 4
BSR_MATMUL_ROWS_STAGE_BYTES = 4096
BSR_MATMUL_ROWS_X_MAX = 96 * 1024
# The cluster size: about UNITS_PER_SM units a streaming multiprocessor
# over the bank, at most CLUSTER_MAX (the portable cluster size), and
# units of at least UNIT_MIN_BYTES on average (a unit is one round trip to
# device memory at least).  One unit an SM splits only banks of fewer
# sub-rows than SMs (wk, wv in (16, 16) tiles: 32): the ablation's
# clusters cost more than they gain on the others (PERF.md).
BSR_MATMUL_ROWS_UNITS_PER_SM = 1
BSR_MATMUL_ROWS_CLUSTER_MAX = 8
BSR_MATMUL_ROWS_UNIT_MIN_BYTES = 2048
# Without a cluster a block takes an equal share of the units, at most
# BLOCKS_PER_SM blocks an SM (0: as many as fit).
BSR_MATMUL_ROWS_BLOCKS_PER_SM = 4
# Rows of x one block sums (a pass; more rows take more passes, each a
# row of blocks): bf16 inputs in groups of 8 (the n of an m16n8k16 mma),
# f32 inputs one f32 sum a row and lane.
BSR_MATMUL_ROWS_PASS_BF16 = (8, 16, 32, 64)
BSR_MATMUL_ROWS_PASS_F32 = (8, 32)
# wgmma: a block of two warpgroups owns 128 rows of x and a group of 16
# sub-rows, and walks x in chunks of 128 columns: a ring of 3 x stages
# and one of 2 stages of the group's pieces (a tile that straddles a
# chunk's edge is taken in two parts, 16 columns at a time).
BSR_MATMUL_WGMMA_ROWS = 128
BSR_MATMUL_WGMMA_GROUP = 16
BSR_MATMUL_WGMMA_CHUNK = 128
BSR_MATMUL_WGMMA_X_STAGES = 3
BSR_MATMUL_WGMMA_TILE_STAGES = 2

# Flash attention (csrc/flash_attention.cu): the head dimensions D every
# one of its kernels instantiates (the split-TF32 and the tensor-core
# forward, dQ and dK/dV).  A head dim d up to the largest runs in the
# smallest D >= d (``flash_head_dim``), its columns [d, D) zero on chip;
# the kernels copy 16 bytes at a time, so d x the operand's itemsize must
# be a multiple of 16 (``flash_head_dim_fault``; ``ops`` pads other d).
FLASH_HEAD_DIMS = (16, 32, 64, 80, 96, 128)
# The split-TF32 kernels (f32): 64-row tiles (wgmma's M) in two
# warpgroups, over chunks of FLASH_TF32_CHUNK keys (the forward, dQ) or
# query rows (dK/dV) up to head dim FLASH_TF32_WIDE_MAX_D, half that above,
# where the backward's chunk of split tiles would not fit.
FLASH_TF32_CHUNK = 64
FLASH_TF32_WIDE_MAX_D = 80
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


# Storage width (bytes) of each sparse-value dtype, the reference's table.
# A quantised bank (int8 / fp8) stores one byte a nonzero plus a
# per-output-channel f32 scale row.
VALUE_ITEMSIZES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "float8_e4m3fn": 1,
}


def value_itemsize(dtype: str) -> int:
    """Bytes a stored sparse value of ``dtype`` (a dtype name) takes."""
    try:
        return VALUE_ITEMSIZES[dtype]
    except KeyError:
        raise ValueError(
            f"unknown sparse value dtype {dtype!r}; expected one of "
            f"{sorted(VALUE_ITEMSIZES)}") from None


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


def ell_stage_bytes(cc: int, rows: int, ws: int, s: int,
                    itemsize: int = 4) -> int:
    """One stage of the ELL conv: the input slab of ``cc`` channels x
    ``rows`` x ``ws`` and ``s`` elements of slack (a dropped pixel's
    reads), in the activation's dtype (``itemsize`` 4: f32, 2: bf16, half
    the bytes), padded to 16 bytes."""
    return -(-(cc * rows * ws + s) * itemsize // 16) * 16


def ell_plane_bytes(cc: int, rows: int, ws: int, s: int) -> int:
    """One plane of a paired bf16 slab (the ELL conv's two pixels a read):
    32-bit words of two elements covering the slab and a slack of ``s`` + 1
    elements, two words more, in a multiple of 4 words (the source's
    ``plane_words``)."""
    words = (cc * rows * ws + s + 2) // 2 + 2
    return -(-4 * words // 16) * 16


def ell_smem_bytes(tm: int, cc: int, c: int, rows: int, ws: int, s: int,
                   pipeline: bool, itemsize: int = 4,
                   paired: bool = False) -> int:
    """Dynamic shared memory of one ELL block: two slab stages when
    pipelined, one when blocking (at the activation's ``itemsize``), the
    int32 source offset of each slab row, and the ``tm`` rows' run bounds
    for each of the C/``cc`` chunks.  A ``paired`` bf16 slab (always
    blocking) keeps its two planes."""
    if paired and pipeline:
        raise ValueError("ell_smem_bytes: a paired slab is never pipelined")
    slabs = (2 * ell_plane_bytes(cc, rows, ws, s) if paired
             else (2 if pipeline else 1)
             * ell_stage_bytes(cc, rows, ws, s, itemsize))
    return slabs + cc * rows * 4 + tm * (-(-c // cc) + 1) * 4


def bsr_conv_tiles(act_itemsize: int = 4) -> tuple:
    """The BCSR conv's (N, warpgroups) tiles on f32 (4) or bf16 (2)
    activations, in the schedule's order of preference."""
    return BSR_CONV_BF16_TILES if act_itemsize == 2 else BSR_CONV_TILES


def bsr_conv_smem_bytes(bm: int, bn: int, n_tile: int, kbc: int,
                        value_itemsize: int = 4,
                        act_itemsize: int = 4) -> int:
    """Dynamic shared memory of one BCSR conv block: two stages (three on
    bf16 activations, ``act_itemsize`` 2), each of the B operand
    (``n_tile`` x ``bn``: TF32 on f32 activations, bf16 on bf16 ones) and
    either the TF32 operand's lo half (f32 tiles on f32 activations) or the
    tiles' narrow bytes (``value_itemsize`` 1: a quantised bank, converted
    on chip into the operand); three slots of ``bn`` int32 column offsets,
    the (n_tile/bm x ``kbc``) table of kept tiles and the ``kbc`` live
    block columns."""
    if value_itemsize == 1:
        extra = 1
    else:
        extra = 0 if act_itemsize == 2 else 4
    stage = n_tile * bn * (act_itemsize + extra)
    stages = 3 if act_itemsize == 2 else 2
    return stages * stage + 4 * (3 * bn + (n_tile // bm + 1) * kbc)


def bsr_matmul_native(bm: int, bn: int) -> bool:
    """Whether the BCSR matmul kernel takes (bm, bn) blocks as they are:
    both positive multiples of 16.  ``ops.bsr_matmul`` re-tiles any other
    block (``ref.retile_bcsr``)."""
    return (bm > 0 and bn > 0 and bm % BSR_MATMUL_PIECE == 0
            and bn % BSR_MATMUL_PIECE == 0)


def bsr_matmul_rows_stage_tiles(bn: int, itemsize: int) -> int:
    """(16, bn) pieces one stage of the ``rows`` ring holds: STAGE_BYTES of
    them, at least one, and enough that the stage's (16, 16) parts deal
    evenly to the consumer warps (part p of a unit is then warp p's mod
    WARPS, whatever its stage)."""
    tiles = max(1, BSR_MATMUL_ROWS_STAGE_BYTES
                // (BSR_MATMUL_PIECE * bn * itemsize))
    while tiles * (bn // 16) % BSR_MATMUL_ROWS_WARPS:
        tiles += 1
    return tiles


def bsr_matmul_rows_pass(rows: int, itemsize: int) -> int:
    """Rows of x one ``rows`` block sums: the smallest pass the source
    instantiates that holds ``rows``, else the largest."""
    passes = BSR_MATMUL_ROWS_PASS_BF16 if itemsize == 2 \
        else BSR_MATMUL_ROWS_PASS_F32
    return next((p for p in passes if p >= rows), passes[-1])


def bsr_matmul_smem_bytes(bn: int = 16, itemsize: int = 2, rows: int = 4,
                          n: int = 4096, cluster: int = 1) -> int:
    """Dynamic shared memory of one ``rows`` block of the BCSR matmul
    (``rows_smem_bytes`` in the source), at any block height (the ring
    holds (16, bn) pieces): 128 bytes of mbarriers; x's rows of the pass
    where staged (bf16, passes of 8 rows, at most X_MAX bytes); the ring of
    stages; the warps' f32 sums of a pass; with a cluster, a slot of a
    pass's sums for each of its blocks."""
    r = bsr_matmul_rows_pass(rows, itemsize)
    x = -(-min(r, rows) * n * itemsize // 128) * 128
    staged = itemsize == 2 and r == 8 and x <= BSR_MATMUL_ROWS_X_MAX
    ring = (BSR_MATMUL_ROWS_STAGES
            * bsr_matmul_rows_stage_tiles(bn, itemsize) * BSR_MATMUL_PIECE
            * bn * itemsize)
    sums = r * BSR_MATMUL_PIECE * 4
    return (128 + (x if staged else 0) + ring
            + BSR_MATMUL_ROWS_WARPS * sums + (cluster * sums if cluster > 1
                                              else 0))


def bsr_matmul_rows_cluster(gm: int, total: int, bm: int, bn: int,
                            itemsize: int) -> int:
    """Units a sub-row (the cluster size) for a bank of ``gm`` block-rows
    of height ``bm`` keeping ``total`` tiles, counted as the kernel walks
    them: gm bm / 16 sub-rows keeping total bm / 16 (16, bn) pieces.
    UNITS_PER_SM x SMS units over the bank, at most CLUSTER_MAX, and at
    least UNIT_MIN_BYTES of pieces a unit on average."""
    s = bm // BSR_MATMUL_PIECE
    want = -(-BSR_MATMUL_ROWS_UNITS_PER_SM * SMS // max(gm * s, 1))
    fill = total * s * BSR_MATMUL_PIECE * bn * itemsize // max(
        gm * s * BSR_MATMUL_ROWS_UNIT_MIN_BYTES, 1)
    return max(1, min(BSR_MATMUL_ROWS_CLUSTER_MAX, want, fill))


def bsr_matmul_wgmma_smem_bytes() -> int:
    """Dynamic shared memory of one ``wgmma`` block: each x stage the bf16
    x chunk of its rows; each tile stage a (16, 16) bf16 slot for every
    16-column block of the chunk and sub-row of the group (a kept piece
    fills up to ``bn / 16`` of them) and a 32-bit mask of filled slots a
    sub-row."""
    x_chunk = BSR_MATMUL_WGMMA_ROWS * BSR_MATMUL_WGMMA_CHUNK * 2
    slots = (BSR_MATMUL_WGMMA_GROUP * (BSR_MATMUL_WGMMA_CHUNK // 16)
             * 16 * 16 * 2)
    return (BSR_MATMUL_WGMMA_X_STAGES * x_chunk
            + BSR_MATMUL_WGMMA_TILE_STAGES
            * (slots + 4 * BSR_MATMUL_WGMMA_GROUP))


def bsr_matmul_unsupported(bm: int, bn: int, n: int,
                           schedule: str = "rows") -> Optional[str]:
    """Why the BCSR matmul kernel's ``schedule`` cannot take a (bm, bn)
    block over N = ``n`` columns as it is, or None.  A block that is not
    ``bsr_matmul_native`` is refused here: ``ops.bsr_matmul`` re-tiles it
    before the launch."""
    if not bsr_matmul_native(bm, bn):
        return (f"block ({bm}, {bn}) is not a multiple of 16 on both sides "
                f"(ops.bsr_matmul re-tiles such a bank)")
    if n % bn:
        return f"N = {n} not a multiple of the block width {bn}"
    if schedule == "rows" and bsr_matmul_rows_width(bn) != bn:
        return (f"block width {bn}: a stage of the rows schedule's ring "
                f"does not fit a block's shared memory (ops.bsr_matmul "
                f"cuts such a bank's tiles to {bsr_matmul_rows_width(bn)} "
                f"columns)")
    return None


@functools.lru_cache(maxsize=None)
def bsr_matmul_rows_width(bn: int) -> int:
    """The widest tile the ``rows`` schedule takes in place of a (bm, bn)
    one: bn itself where a stage of its ring of (16, bn) pieces fits a
    block's shared memory (f32 pieces, the widest pass), else the widest
    multiple of 16 dividing bn that fits (bn about 880 and up, or narrower
    where bn / 16 is odd and a stage must hold 4 pieces).
    ``ops.bsr_matmul`` cuts a wider bank's tiles side by side to it
    (``ref.split_bcsr``)."""
    for w in range(bn, 0, -BSR_MATMUL_PIECE):
        if bn % w == 0 and smem_fits(bsr_matmul_smem_bytes(
                w, 4, BSR_MATMUL_ROWS_PASS_F32[-1], 0,
                BSR_MATMUL_ROWS_CLUSTER_MAX)):
            return w
    raise ValueError(f"block width {bn}: no multiple of "
                     f"{BSR_MATMUL_PIECE} dividing it fits the rows ring")


def flash_head_dim(d: int) -> int:
    """The instantiated head dim D the kernels run head dim ``d`` in: the
    smallest of FLASH_HEAD_DIMS at least ``d``.  Raises above the
    largest."""
    for dim in FLASH_HEAD_DIMS:
        if dim >= d:
            return dim
    raise ValueError(f"head dim {d} above {FLASH_HEAD_DIMS[-1]}, the largest "
                     f"the flash kernels are built for")


def flash_head_dim_fault(d: int, itemsize: int) -> Optional[str]:
    """Why the flash kernels cannot take head dim ``d`` of an operand of
    ``itemsize`` bytes as it is, or None: d at least 1 and at most the
    largest instantiation, and a row of d elements a multiple of 16 bytes
    (the kernels' copies)."""
    if d < 1 or d > FLASH_HEAD_DIMS[-1]:
        return (f"head dim {d} outside 1 .. {FLASH_HEAD_DIMS[-1]}, the "
                f"largest the kernels are built for")
    if d * itemsize % 16:
        return (f"head dim {d}: a row of {d * itemsize} bytes is not a "
                f"multiple of the kernels' 16-byte copies")
    return None


def flash_tf32_chunk(d: int) -> int:
    """Keys (the forward, dQ) or query rows (dK/dV) of a split-TF32 chunk
    at head dim ``d`` (its instantiation's, ``flash_head_dim``)."""
    d = flash_head_dim(d)
    return FLASH_TF32_CHUNK if d <= FLASH_TF32_WIDE_MAX_D else \
        FLASH_TF32_CHUNK // 2


def _flash_raw_row(d: int) -> int:
    """Words of a row of a raw f32 A tile: d when it is a multiple of 32
    (the columns swizzled by the row), else padded by 4."""
    return d if d % 32 == 0 else d + 4


def flash_fwd_tf32_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one split-TF32 forward block: a raw f32 q
    tile (64 rows) for each of its two warpgroups, and the chunk's K (hi
    and lo halves), V as copied and V transposed (hi and lo, a padded slot
    group)."""
    d = flash_head_dim(d)
    chunk = flash_tf32_chunk(d)
    return 4 * (2 * 64 * _flash_raw_row(d) + chunk * (3 * d + 2 * (d + 1)))


def flash_bwd_dq_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one split-TF32 dQ block: raw f32 q and dO
    tiles (64 rows) for each of its two warpgroups, and the chunk's K and V
    (hi and lo halves, K also transposed with a padded slot group)."""
    d = flash_head_dim(d)
    chunk = flash_tf32_chunk(d)
    return 4 * (4 * 64 * _flash_raw_row(d) + chunk * (4 * d + 2 * (d + 1)))


def flash_bwd_dkv_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one split-TF32 dK/dV block: raw f32 K and
    V (64 keys), the chunk's q and dO (hi and lo, each also transposed),
    two slots of the rows' lse and delta, and the p^T its two warpgroups
    exchange (one f32 slot a thread and accumulator element)."""
    d = flash_head_dim(d)
    chunk = flash_tf32_chunk(d)
    return 4 * (2 * 64 * _flash_raw_row(d)
                + chunk * (4 * d + 4 * (d + 1) + 4 + 64))


def flash_tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core forward block: a bf16 query
    tile for each warpgroup and the stages of key and value tiles, each
    ``FLASH_TC_BQ`` x d."""
    d = flash_head_dim(d)
    tiles = FLASH_TC_FWD_WARPGROUPS + 2 * FLASH_TC_FWD_STAGES
    return 2 * FLASH_TC_BQ * d * tiles


def flash_bwd_dq_tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core dQ block: a bf16 query tile
    and a dO tile for each warpgroup and the stages of key and value tiles,
    each ``FLASH_TC_BQ`` x d."""
    d = flash_head_dim(d)
    tiles = 2 * FLASH_TC_DQ_WARPGROUPS + 2 * FLASH_TC_DQ_STAGES
    return 2 * FLASH_TC_BQ * d * tiles


def flash_bwd_dkv_tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core dK/dV block: its bf16 key
    and value tiles, the stages of query and dO tiles and of their lse and
    delta rows (f32), and the f32 p passed between its two warpgroups."""
    d = flash_head_dim(d)
    return (2 * FLASH_TC_BQ * d * (2 + 2 * FLASH_TC_DKV_STAGES)
            + 4 * (2 * FLASH_TC_DKV_STAGES * FLASH_TC_BQ
                   + 32 * FLASH_TC_WARPGROUP))


# Each flash helper above sizes the kernel that runs head dim ``d``: its
# instantiation's, ``flash_head_dim(d)``.


def smem_fits(nbytes: int) -> bool:
    return nbytes <= SMEM_MAX
