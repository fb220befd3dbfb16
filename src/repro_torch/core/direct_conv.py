"""Direct sparse convolution (the paper's Algorithm 2) and the dense oracle.

Port of ``repro/core/direct_conv.py``:

    out[n, m, e, f] += value[m, k] * xpad[n, c[m,k], e*stride + r[m,k],
                                               f*stride + s[m,k]]

``direct_sparse_conv`` is the ``csr-direct`` method: a plain PyTorch loop
over the K (padded nnz-per-filter) axis, each step one gathered (N, M, E, F)
window product for every row at once.  The windows are gathered from the
flat padded input by stretched offsets (the paper's weight stretching).
``dense_conv`` is ``F.conv2d`` on the zero-filled weights (the JAX package
leaves it to XLA; cuDNN stands in here, with TF32 off, see
``repro_torch/__init__.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import EllConv


def out_spatial(h: int, w: int, r: int, s: int, stride: int,
                padding: int) -> Tuple[int, int]:
    e = (h + 2 * padding - r) // stride + 1
    f = (w + 2 * padding - s) // stride + 1
    return e, f


def pad_in(x: torch.Tensor, padding: int) -> torch.Tensor:
    """The paper's pad_in step: one explicit zero pad of H and W."""
    if padding == 0:
        return x.contiguous()
    return F.pad(x, (padding, padding, padding, padding))


def stretched_offsets(cidx: torch.Tensor, ridx: torch.Tensor,
                      sidx: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The paper's *weight stretching*: the flat offset ``(c*Hp + r)*Wp + s``
    of each nonzero's window origin in one padded (C, Hp, Wp) image."""
    return (cidx.long() * hp + ridx.long()) * wp + sidx.long()


def pixel_offsets(wp: int, e: int, f: int, stride: int,
                  device) -> torch.Tensor:
    """Flat offset ``e*stride*Wp + f*stride`` of each output pixel's window
    within a padded image, (E*F,) in (e, f) row-major order."""
    rows = torch.arange(e, device=device) * (stride * wp)
    cols = torch.arange(f, device=device) * stride
    return (rows[:, None] + cols[None, :]).reshape(-1)


def gather_windows(xpad: torch.Tensor, off: torch.Tensor,
                   pix: torch.Tensor) -> torch.Tensor:
    """Windows of a padded (N, C, Hp, Wp) input at stretched offsets ``off``
    (any shape): returns (N, *off.shape, E*F), element ``[n, ..., p]`` being
    ``xpad`` flat at ``off[...] + pix[p]``."""
    n = xpad.shape[0]
    flat = xpad.reshape(n, -1)
    idx = (off.reshape(-1, 1) + pix.reshape(1, -1)).reshape(-1)
    return flat.index_select(1, idx).view(n, *off.shape, pix.numel())


def direct_sparse_conv(x: torch.Tensor, ell: EllConv, *, stride: int = 1,
                       padding: int = 0) -> torch.Tensor:
    """(N, C, H, W) input, ELL bank for (M, C, R, S) weights -> (N, M, E, F)
    in ``x.dtype``, accumulated in f32 nonzero by nonzero over all K."""
    n, c, h, w = x.shape
    m, cw, r, s = ell.shape
    if cw != c:
        raise ValueError(f"input has C={c} but filters expect C={cw}")
    e, f = out_spatial(h, w, r, s, stride, padding)
    xpad = pad_in(x, padding)
    off = stretched_offsets(ell.cidx, ell.ridx, ell.sidx, *xpad.shape[2:])
    pix = pixel_offsets(xpad.shape[3], e, f, stride, x.device)
    value = ell.value.float()
    out = torch.zeros((n, m, e * f), dtype=torch.float32, device=x.device)
    for k in range(ell.k):
        out += value[:, k].view(1, m, 1) * gather_windows(xpad, off[:, k],
                                                          pix).float()
    out = out.view(n, m, e, f)
    return out.to(x.dtype)


def dense_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """Dense oracle: the library convolution on (zero-filled) dense weights."""
    return F.conv2d(x, w, stride=stride, padding=padding)
