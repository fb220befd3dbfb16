"""Plain PyTorch versions of the BCSR matmul kernel.

``bsr_matmul_plain`` takes the kernel's operands and returns what the kernel
returns: for every kept tile ``kb < nblocks[i]`` of every block-row, the
input columns ``blockcol[i, kb]*bn .. +bn`` are gathered and contracted in
f32 against the (bm, bn) tile, summed tile by tile.  It loops over the KB
axis (vectorised over block-rows), so it holds one gathered (B, gm, bn)
slab at a time.  Inside a tile the library's summation order is not the
kernel's, so the two agree to f32 rounding, not bit for bit.

``rows_units`` builds the ``rows`` schedule's work list from a bank's
tile counts, and ``bsr_matmul_rows_plain`` mirrors that schedule's
partition and order of sums on it: each block-row's run of kept tiles cut
into units (a cluster of blocks), each unit's (16, 16) pieces dealt to its
warps in turn, the warps' sums added in warp order, and a block-row's
unit sums added in unit order.

``bsr_matmul_walk_plain`` mirrors the ``wgmma`` schedule's traversal:
groups of block-rows, each walking the columns of x in chunks with one
pointer a block-row, taking the run of its tiles whose block columns fall
in the chunk and stopping at ``nblocks``.  It is used by the tests, never
on the main path.

``bsr_matmul_ref`` is the port of the reference's oracle
(``repro/kernels/bsr_matmul/ref.py``): a dense f32 product with the
reconstructed weight.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import BcsrMatrix, bcsr_to_dense


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


# the fields of a ``rows`` unit: its block-row, its run of tiles
# [kb0, kb1), and its rank among the block-row's units
UNIT_FIELDS = ("row", "kb0", "kb1", "rank")


def rows_units(counts, cluster: int) -> torch.Tensor:
    """The ``rows`` schedule's work list for a bank whose block-rows keep
    ``counts`` tiles (a list or an int tensor): each block-row's run of
    tiles [0, count) cut into ``cluster`` consecutive units whose sizes
    differ by at most one (some empty where a block-row keeps fewer
    tiles; a block-row of no tile writes zeros), in block-row order.
    Returns (len(counts) * cluster, 4) int32 on the CPU, columns
    ``UNIT_FIELDS``."""
    if cluster < 1:
        raise ValueError(f"cluster {cluster} < 1")
    counts = counts.tolist() if isinstance(counts, torch.Tensor) else counts
    units = [(i, j * nb // cluster, (j + 1) * nb // cluster, j)
             for i, nb in enumerate(counts) for j in range(cluster)]
    return torch.tensor(units, dtype=torch.int32).reshape(-1, 4)


def rows_cols(units: torch.Tensor, blockcol: torch.Tensor) -> torch.Tensor:
    """The block columns of each unit's tiles, the ``rows`` schedule's
    second part of its work list: (units, maxt) int32 on the CPU, row u
    holding ``blockcol[row, kb0:kb1]`` of unit u then zeros, maxt the most
    tiles a unit holds (at least 1).  The kernel reads them at a fixed
    stride, without first reading the unit's descriptor."""
    spans = units.tolist()
    maxt = max([kb1 - kb0 for _, kb0, kb1, _ in spans] + [1])
    bc = blockcol.cpu()
    cols = torch.zeros((len(spans), maxt), dtype=torch.int32)
    for u, (row, kb0, kb1, _) in enumerate(spans):
        cols[u, :kb1 - kb0] = bc[row, kb0:kb1]
    return cols


def bsr_matmul_rows_plain(x: torch.Tensor, blocks: torch.Tensor,
                          blockcol: torch.Tensor, nblocks: torch.Tensor,
                          units: torch.Tensor, *,
                          warps: int = 4) -> torch.Tensor:
    """The ``rows`` schedule's sums on the kernel's operands and its work
    list ``units`` (``rows_units``): unit u sums the (bm, 16) pieces of its
    tiles, piece p (tile p // (bn / 16), columns 16 (p % (bn / 16)) on)
    going to warp p % ``warps``, each warp in piece order; the unit's sum
    is warp 0's + warp 1's + ...; a block-row is its units' sums in unit
    order.  -> (B, gm*bm) f32."""
    b, _ = x.shape
    gm, _, bm, bn = blocks.shape
    ks = bn // 16
    xf = x.float()
    out = torch.zeros((b, gm, bm), dtype=torch.float32, device=x.device)
    rows = {}
    for row, kb0, kb1, _ in units.tolist():
        unit = torch.zeros((b, bm), dtype=torch.float32, device=x.device)
        warp = [torch.zeros_like(unit) for _ in range(warps)]
        for p in range((kb1 - kb0) * ks):
            kb, k = kb0 + p // ks, 16 * (p % ks)
            c = int(blockcol[row, kb]) * bn + k
            warp[p % warps] += (xf[:, c:c + 16]
                                @ blocks[row, kb, :, k:k + 16].float().T)
        for w in warp:
            unit += w
        rows.setdefault(row, []).append(unit)
    for row, sums in rows.items():
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        out[:, row] = total
    return out.reshape(b, gm * bm)


def bsr_matmul_walk_plain(x: torch.Tensor, blocks: torch.Tensor,
                          blockcol: torch.Tensor, nblocks: torch.Tensor, *,
                          group: int = 16, chunk: int = 128) -> torch.Tensor:
    """The ``wgmma`` schedule's walk on the kernel's operands: for each
    group of ``group`` block-rows, the columns of x in chunks of ``chunk``
    (a multiple of bn), each block-row's pointer taking the run of its
    tiles from the pointer on whose block columns fall in the chunk.  A
    pointer that stops short of ``nblocks`` (block columns not ascending)
    raises.  -> (B, gm*bm) f32."""
    b, n = x.shape
    gm, _, bm, bn = blocks.shape
    if chunk % bn:
        raise ValueError(f"chunk {chunk} not a multiple of bn {bn}")
    xf = x.float()
    out = torch.zeros((b, gm, bm), dtype=torch.float32, device=x.device)
    counts = nblocks.tolist()
    cols = blockcol.tolist()
    for i0 in range(0, gm, group):
        rows = range(i0, min(gm, i0 + group))
        ptr = {i: 0 for i in rows}
        for col0 in range(0, n, chunk):
            for i in rows:
                while (ptr[i] < counts[i]
                       and col0 <= cols[i][ptr[i]] * bn < col0 + chunk):
                    c = cols[i][ptr[i]] * bn
                    out[:, i] += xf[:, c:c + bn] @ blocks[i, ptr[i]].float().T
                    ptr[i] += 1
        stuck = [i for i in rows if ptr[i] != counts[i]]
        if stuck:
            raise ValueError(f"block columns of rows {stuck} not ascending")
    return out.reshape(b, gm * bm)


def bsr_matmul_ref(x: torch.Tensor, b: BcsrMatrix) -> torch.Tensor:
    """y = x @ W.T in float32, from the dense reconstruction of W."""
    return torch.matmul(x.float(), bcsr_to_dense(b).float().T)
