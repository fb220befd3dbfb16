"""Plain PyTorch versions of the BCSR matmul kernel.

``bsr_matmul_plain`` takes the kernel's operands and returns what the kernel
returns: for every kept tile ``kb < nblocks[i]`` of every block-row, the
input columns ``blockcol[i, kb]*bn .. +bn`` are gathered and contracted in
f32 against the (bm, bn) tile, summed tile by tile.  It loops over the KB
axis (vectorised over block-rows), so it holds one gathered (B, gm, bn)
slab at a time.  Inside a tile the library's summation order is not the
kernel's, so the two agree to f32 rounding, not bit for bit.

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
