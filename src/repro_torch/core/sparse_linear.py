"""Sparse linear products: the paper's mechanism applied to 2-D weights.

Port of ``repro/core/sparse_linear.py``.  All compute ``y = x @ W.T`` for a
weight of logical shape (M, N) and ``x`` of shape (..., N):

  ell_matmul   -- direct ELL traversal, a plain loop over the K nonzeros of
                  each row, every step one gathered column per row
  bcsr_matmul  -- block-sparse: gather the input tiles each kept weight tile
                  needs, contract in f32 (the plain version of the
                  ``bsr_matmul`` kernel's product)
  dense_matmul -- zero-filled dense product, f32 accumulate
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import BcsrMatrix, EllMatrix


def ell_matmul(x: torch.Tensor, ell: EllMatrix) -> torch.Tensor:
    """Direct ELL sparse matmul over the last axis of ``x``, f32 accumulate."""
    m, n = ell.shape
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != weight N {n}")
    colidx = ell.colidx.long()
    value = ell.value.float()
    out = torch.zeros(x.shape[:-1] + (m,), dtype=torch.float32,
                      device=x.device)
    for k in range(ell.k):
        out += value[:, k] * x.index_select(-1, colidx[:, k]).float()
    return out.to(x.dtype)


def bcsr_matmul(x: torch.Tensor, b: BcsrMatrix) -> torch.Tensor:
    """Block-sparse matmul: gather the input tiles of every kept weight tile,
    then one f32 contraction; the result is cast to ``x.dtype``.

    y[..., i*bm:(i+1)*bm] = sum_kb  x_tiles[..., blockcol[i,kb], :] @ blocks[i,kb].T
    (padding tiles are zero, so they add nothing).
    """
    m, n = b.shape
    bm, bn = b.block
    if x.shape[-1] != n:
        raise ValueError(f"x last dim {x.shape[-1]} != weight N {n}")
    xb = torch.nn.functional.pad(x, (0, (-n) % bn))
    gn = xb.shape[-1] // bn
    xb = xb.reshape(x.shape[:-1] + (gn, bn))
    # (..., gm, KB, bn): per block-row, the input tiles its kept tiles touch.
    gathered = xb[..., b.blockcol.long(), :]
    out = torch.einsum("...gkn,gkmn->...gm", gathered.float(), b.blocks.float())
    out = out.reshape(x.shape[:-1] + (b.blocks.shape[0] * bm,))
    return out[..., :m].to(x.dtype)


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero-filled dense matmul of an (M, N) weight, y = x @ W.T, f32
    accumulate, cast to ``x.dtype``."""
    return torch.matmul(x.float(), w.float().T).to(x.dtype)
