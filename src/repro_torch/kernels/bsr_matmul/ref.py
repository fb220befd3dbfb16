"""Plain PyTorch versions of the BCSR matmul kernel.

``bsr_matmul_plain`` takes the kernel's operands and returns what the kernel
returns: for every kept tile ``kb < nblocks[i]`` of every block-row, the
input columns ``blockcol[i, kb]*bn .. +bn`` are gathered and contracted in
f32 against the (bm, bn) tile, summed tile by tile.  It loops over the KB
axis (vectorised over block-rows), so it holds one gathered (B, gm, bn)
slab at a time.  Inside a tile the library's summation order is not the
kernel's, so the two agree to f32 rounding, not bit for bit.

Both schedules of the kernel read a (bm, bn) bank (bm a multiple of 16) as
gm bm / 16 *sub-rows*: sub-row r = (i, j), i = r // (bm / 16), reads the
(16, bn) piece j (tile rows 16 j .. 16 j + 15) of each of block-row i's
kept tiles and writes outputs 16 r .. 16 r + 15.  At bm = 16 a sub-row is
a block-row.

``rows_units`` builds the ``rows`` schedule's work list from the
sub-rows' tile counts (``subrow_counts``), and ``bsr_matmul_rows_plain``
mirrors that schedule's partition and order of sums on it: each sub-row's
run of kept pieces cut into units (a cluster of blocks), each unit's
(16, 16) parts dealt to its warps in turn, the warps' sums added in warp
order, and a sub-row's unit sums added in unit order.

``bsr_matmul_walk_plain`` mirrors the ``wgmma`` schedule's traversal:
groups of sub-rows, each walking the columns of x in chunks with one
pointer a sub-row, taking the (16, 16) parts of its pieces that fall in
the chunk (a tile across the chunk's edge in two parts) and stopping at
``nblocks``.  It is used by the tests, never on the main path.

``retile_bcsr`` puts each tile of a bank whose block is not a multiple of
16 on both sides into a tile of the next multiples of 16, zero filled:
the bank ``ops.bsr_matmul`` hands the kernel for such a block.

``bsr_matmul_ref`` is the port of the reference's oracle
(``repro/kernels/bsr_matmul/ref.py``): a dense f32 product with the
reconstructed weight.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import BcsrMatrix, bcsr_to_dense
from repro_torch.kernels.budget import BSR_MATMUL_PIECE as PIECE


def bsr_matmul_plain(x: torch.Tensor, blocks: torch.Tensor,
                     blockcol: torch.Tensor,
                     nblocks: torch.Tensor) -> torch.Tensor:
    """x (B, N) with N % bn == 0; blocks (gm, KB, bm, bn); blockcol (gm, KB)
    int32; nblocks (gm,) int32 -> (B, gm*bm) f32."""
    b, n = x.shape
    gm, _, bm, bn = blocks.shape
    xt = x.float().reshape(b, n // bn, bn)
    acc = torch.zeros((b, gm, bm), dtype=torch.float32, device=x.device)
    kb_n = int(nblocks.max()) if gm else 0
    for kb in range(kb_n):
        live = (nblocks > kb).view(gm, 1, 1)
        tile = torch.where(live, blocks[:, kb].float(), 0.0)  # (gm, bm, bn)
        xg = xt[:, blockcol[:, kb].long()]                   # (B, gm, bn)
        acc += torch.einsum("bgn,gmn->bgm", xg, tile)
    return acc.reshape(b, gm * bm)


# the fields of a ``rows`` unit: its sub-row, its run of tiles [kb0, kb1),
# and its rank among the sub-row's units
UNIT_FIELDS = ("row", "kb0", "kb1", "rank")


def subrow_counts(nblocks, bm: int) -> list:
    """The kept tiles of each sub-row of a bank of height ``bm``: block-row
    i's count ``nblocks[i]`` once for each of its bm / 16 sub-rows."""
    counts = nblocks.tolist() if isinstance(nblocks, torch.Tensor) \
        else list(nblocks)
    return [c for c in counts for _ in range(bm // PIECE)]


def rows_units(counts, cluster: int) -> torch.Tensor:
    """The ``rows`` schedule's work list for a bank whose sub-rows keep
    ``counts`` tiles (a list or an int tensor; ``subrow_counts``): each
    sub-row's run of tiles [0, count) cut into ``cluster`` consecutive
    units whose sizes differ by at most one (some empty where a sub-row
    keeps fewer tiles; a sub-row of no tile writes zeros), in sub-row
    order.  Returns (len(counts) * cluster, 4) int32 on the CPU, columns
    ``UNIT_FIELDS``."""
    if cluster < 1:
        raise ValueError(f"cluster {cluster} < 1")
    counts = counts.tolist() if isinstance(counts, torch.Tensor) else counts
    units = [(i, j * nb // cluster, (j + 1) * nb // cluster, j)
             for i, nb in enumerate(counts) for j in range(cluster)]
    return torch.tensor(units, dtype=torch.int32).reshape(-1, 4)


def rows_cols(units: torch.Tensor, blockcol: torch.Tensor,
              bm: int = PIECE) -> torch.Tensor:
    """The block columns of each unit's tiles, the ``rows`` schedule's
    second part of its work list: (units, maxt) int32 on the CPU, row u
    holding ``blockcol[i, kb0:kb1]`` of unit u's block-row i (its sub-row
    // (``bm`` / 16)) then zeros, maxt the most tiles a unit holds (at
    least 1).  The kernel reads them at a fixed stride, without first
    reading the unit's descriptor."""
    spans = units.tolist()
    s = bm // PIECE
    maxt = max([kb1 - kb0 for _, kb0, kb1, _ in spans] + [1])
    bc = blockcol.cpu()
    cols = torch.zeros((len(spans), maxt), dtype=torch.int32)
    for u, (row, kb0, kb1, _) in enumerate(spans):
        cols[u, :kb1 - kb0] = bc[row // s, kb0:kb1]
    return cols


def bsr_matmul_rows_plain(x: torch.Tensor, blocks: torch.Tensor,
                          blockcol: torch.Tensor, nblocks: torch.Tensor,
                          units: torch.Tensor, *,
                          warps: int = 4) -> torch.Tensor:
    """The ``rows`` schedule's sums on the kernel's operands and its work
    list ``units`` (``rows_units`` over ``subrow_counts``): unit u of
    sub-row (i, j) sums the (16, 16) parts of its pieces, part p (tile
    p // (bn / 16), columns 16 (p % (bn / 16)) on, tile rows 16 j on)
    going to warp p % ``warps``, each warp in part order; the unit's sum
    is warp 0's + warp 1's + ...; a sub-row is its units' sums in unit
    order.  -> (B, gm*bm) f32."""
    b, _ = x.shape
    gm, _, bm, bn = blocks.shape
    s, ks = bm // PIECE, bn // PIECE
    xf = x.float()
    out = torch.zeros((b, gm * s, PIECE), dtype=torch.float32,
                      device=x.device)
    rows = {}
    for row, kb0, kb1, _ in units.tolist():
        i, j = divmod(row, s)
        unit = torch.zeros((b, PIECE), dtype=torch.float32, device=x.device)
        warp = [torch.zeros_like(unit) for _ in range(warps)]
        for p in range((kb1 - kb0) * ks):
            kb, k = kb0 + p // ks, PIECE * (p % ks)
            c = int(blockcol[i, kb]) * bn + k
            part = blocks[i, kb, PIECE * j:PIECE * (j + 1), k:k + PIECE]
            warp[p % warps] += xf[:, c:c + PIECE] @ part.float().T
        for w in warp:
            unit += w
        rows.setdefault(row, []).append(unit)
    for row, sums in rows.items():
        total = sums[0]
        for t in sums[1:]:
            total = total + t
        out[:, row] = total
    return out.reshape(b, gm * bm)


def bsr_matmul_walk_plain(x: torch.Tensor, blocks: torch.Tensor,
                          blockcol: torch.Tensor, nblocks: torch.Tensor, *,
                          group: int = 16, chunk: int = 128) -> torch.Tensor:
    """The ``wgmma`` schedule's walk on the kernel's operands: for each
    group of ``group`` sub-rows, the columns of x in chunks of ``chunk``
    (a multiple of 16), each sub-row's pointer taking the run of its
    tiles from the pointer on that overlap the chunk, each tile's piece
    (16, 16) part by part where its columns fall in the chunk; the
    pointer passes a tile once its last part is taken, so a tile across
    the chunk's edge is taken in two parts.  A pointer that stops short of
    ``nblocks`` (block columns not ascending) raises.  -> (B, gm*bm)
    f32."""
    b, n = x.shape
    gm, _, bm, bn = blocks.shape
    if chunk % PIECE:
        raise ValueError(f"chunk {chunk} not a multiple of {PIECE}")
    s = bm // PIECE
    xf = x.float()
    out = torch.zeros((b, gm * s, PIECE), dtype=torch.float32,
                      device=x.device)
    counts = nblocks.tolist()
    cols = blockcol.tolist()
    for r0 in range(0, gm * s, group):
        rows = range(r0, min(gm * s, r0 + group))
        ptr = {r: 0 for r in rows}
        for col0 in range(0, n, chunk):
            end = col0 + chunk
            for r in rows:
                i, j = divmod(r, s)
                while ptr[r] < counts[i]:
                    c = cols[i][ptr[r]] * bn
                    if not (col0 < c + bn and c < end):
                        break
                    tile = blocks[i, ptr[r], PIECE * j:PIECE * (j + 1)]
                    for k in range(max(c, col0), min(c + bn, end), PIECE):
                        out[:, r] += (xf[:, k:k + PIECE]
                                      @ tile[:, k - c:k - c + PIECE].float().T)
                    if c + bn > end:
                        break          # its other parts in the next chunk
                    ptr[r] += 1
        stuck = sorted({r // s for r in rows
                        if ptr[r] != counts[r // s]})
        if stuck:
            raise ValueError(f"block columns of rows {stuck} not ascending")
    return out.reshape(b, gm * bm)


def retiled_block(block) -> tuple:
    """The block the kernel takes for ``block``: each side rounded up to a
    multiple of 16."""
    return tuple(-(-side // PIECE) * PIECE for side in block)


def retile_bcsr(w: BcsrMatrix) -> BcsrMatrix:
    """``w`` with each (bm, bn) tile placed at the top left of a tile of
    ``retiled_block``, zero filled; the block columns and counts as they
    are.  Its logical shape is the padded grid's, (gm bm', gn bn'): the
    product needs x with each bn columns spread to bn' (the added columns
    zero) and keeps the first bm of each bm' outputs (``ops.bsr_matmul``).
    A zero row of a tile thus writes only outputs that are dropped, a zero
    column multiplies only a zero column of x: no padding meets a value of
    x that the tile does not read (an inf there would make NaN of it)."""
    bm, bn = w.block
    bm2, bn2 = retiled_block(w.block)
    gm, kb = w.blocks.shape[:2]
    gn = -(-w.shape[1] // bn)
    blocks = torch.nn.functional.pad(w.blocks, (0, bn2 - bn, 0, bm2 - bm))
    return BcsrMatrix(blocks=blocks, blockcol=w.blockcol, nblocks=w.nblocks,
                      shape=(gm * bm2, gn * bn2), block=(bm2, bn2))


def split_bcsr(w: BcsrMatrix, width: int) -> BcsrMatrix:
    """``w`` with each (bm, bn) tile cut side by side into bn / ``width``
    tiles of (bm, ``width``): kept tile k at block column c becomes tiles
    k s + j at block columns c s + j (s = bn / width, j < s), so each
    block-row's columns stay ascending and x's layout is unchanged.  The
    same values in as many bytes (``ops.bsr_matmul`` for a bank too wide
    for the ``rows`` schedule, ``budget.bsr_matmul_rows_width``)."""
    bm, bn = w.block
    if bn % width:
        raise ValueError(f"width {width} does not divide the block width "
                         f"{bn}")
    s = bn // width
    gm, kb = w.blocks.shape[:2]
    blocks = w.blocks.reshape(gm, kb, bm, s, width).transpose(2, 3)
    j = torch.arange(s, dtype=w.blockcol.dtype, device=w.blockcol.device)
    return BcsrMatrix(
        blocks=blocks.reshape(gm, kb * s, bm, width).contiguous(),
        blockcol=(w.blockcol[:, :, None] * s + j).reshape(gm, kb * s),
        nblocks=w.nblocks * s, shape=w.shape, block=(bm, width))


def bsr_matmul_ref(x: torch.Tensor, b: BcsrMatrix) -> torch.Tensor:
    """y = x @ W.T in float32, from the dense reconstruction of W."""
    return torch.matmul(x.float(), bcsr_to_dense(b).float().T)
