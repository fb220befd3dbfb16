"""The *lowering* method (paper Section 2.2): im2col + ELL SpMM.

Port of ``repro/core/lowering.py``.  ``im2col`` duplicates each input
element up to R*S times into an (N, E*F, C*R*S) matrix, with the last axis
in (c, r, s) row-major order to match a (M, C*R*S) reshape of OIHW weights;
``lowered_sparse_conv`` multiplies it by the ELL bank (the CUSPARSE
analogue, the ``lowered`` method).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.direct_conv import out_spatial
from repro_torch.core.sparse_format import EllMatrix
from repro_torch.core.sparse_linear import ell_matmul


def im2col(x: torch.Tensor, r: int, s: int, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Lower (N, C, H, W) input to the duplicated (N, E*F, C*R*S) matrix."""
    cols = F.unfold(x, (r, s), padding=padding, stride=stride)  # (N, CRS, EF)
    return cols.transpose(1, 2)


def lowered_sparse_conv(x: torch.Tensor, ell2d: EllMatrix, r: int, s: int, *,
                        stride: int = 1, padding: int = 0) -> torch.Tensor:
    """im2col + CSR SpMM; ``ell2d`` is the (M, C*R*S) reshape of the pruned
    bank in ELL form."""
    m, _ = ell2d.shape
    n, _, h, w = x.shape
    e, f = out_spatial(h, w, r, s, stride, padding)
    out = ell_matmul(im2col(x, r, s, stride=stride, padding=padding), ell2d)
    return out.transpose(1, 2).reshape(n, m, e, f)
