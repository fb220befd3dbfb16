"""Sparse linear products: the paper's mechanism applied to 2-D weights.

Port of ``repro/core/sparse_linear.py:ell_matmul``: ``y = x @ W.T`` for an
ELL weight of logical shape (M, N), a plain loop over the K nonzeros of each
row, every step one gathered column per row.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import EllMatrix


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
