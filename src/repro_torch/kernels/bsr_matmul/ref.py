"""Plain PyTorch versions of the BCSR matmul kernel.

``bsr_matmul_plain`` takes the kernel's operands and returns what the kernel
returns: for every kept tile ``kb < nblocks[i]`` of every block-row, the
input columns ``blockcol[i, kb]*bn .. +bn`` are gathered and contracted in
f32 against the (bm, bn) tile, summed tile by tile.  It loops over the KB
axis (vectorised over block-rows), so it holds one gathered (B, gm, bn)
slab at a time.  Inside a tile the library's summation order is not the
kernel's, so the two agree to f32 rounding, not bit for bit.

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
        live = (nblocks > kb).float().view(gm, 1, 1)
        tile = blocks[:, kb].float() * live                  # (gm, bm, bn)
        xg = xt[:, blockcol[:, kb].long()]                   # (B, gm, bn)
        acc += torch.einsum("bgn,gmn->bgm", xg, tile)
    return acc.reshape(b, gm * bm)


def bsr_matmul_ref(x: torch.Tensor, b: BcsrMatrix) -> torch.Tensor:
    """y = x @ W.T in float32, from the dense reconstruction of W."""
    return torch.matmul(x.float(), bcsr_to_dense(b).float().T)
