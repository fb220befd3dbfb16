"""Plain PyTorch version of the ELL direct sparse conv kernel.

Same operands and the same result as ``csrc/sparse_conv.cu``: every row's
sum is formed nonzero by nonzero in f32 (``acc + value * window``, the
multiply and the add rounded separately), then bias, residual and ReLU are
applied in the kernel's order.  It is vectorised over rows and pixels and
loops only over the K axis, up to the longest row; a row's entries past its
``nnz`` are padding with value 0, so adding them leaves its sum unchanged.

The CPU tests run the port through it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.direct_conv import (gather_windows, pixel_offsets,
                                          stretched_offsets)


def sparse_conv_plain(xpad: torch.Tensor, value: torch.Tensor,
                      packed_idx: torch.Tensor, nnz: torch.Tensor,
                      bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None, *, rs: int,
                      s: int, e: int, f: int, stride: int = 1,
                      fuse_relu: bool = False) -> torch.Tensor:
    """(N, C, Hp, Wp) padded input, (M, K) values and packed indices ->
    (N, M, E, F) f32 with the fused epilogue."""
    n, _, hp, wp = xpad.shape
    m = value.shape[0]
    xpad = xpad.float()
    packed = packed_idx.long()
    cidx = packed // rs
    ridx = (packed - cidx * rs) // s
    sidx = packed - cidx * rs - ridx * s
    off = stretched_offsets(cidx, ridx, sidx, hp, wp)
    pix = pixel_offsets(wp, e, f, stride, xpad.device)
    value = value.float()
    acc = torch.zeros((n, m, e * f), dtype=torch.float32, device=xpad.device)
    kmax = int(nnz.max()) if m else 0
    for k in range(kmax):
        acc += value[:, k].view(1, m, 1) * gather_windows(xpad, off[:, k], pix)
    acc = acc.view(n, m, e, f)
    acc += bias.float().view(1, m, 1, 1)
    if residual is not None:
        acc += residual.float()
    if fuse_relu:
        acc = torch.relu(acc)
    return acc
