"""Magnitude weight pruning (Han et al. lineage, as used by the paper).

Port of ``repro/core/pruning.py``: ``magnitude_prune`` on the host in numpy
(the CNN weights are drawn on the host), and ``block_prune`` and
``block_prune_conv`` on a tensor on any device (the transformer's weights
are drawn on the card, one matrix at a time; a numpy filter bank is pruned
on the host and returned as numpy).  Both thresholds repeat ``jnp.quantile``'s linear interpolation in
float32 (sort, ``q * (n - 1)``, floor/ceil weights, ``lo * w_lo + hi * w_hi``),
so the kept mask matches the reference's up to ties at the threshold.
``torch.quantile`` is not used: it interpolates in another order and
refuses more than 2**24 elements.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import SparsityConfig


def _quantile_weights(n: int, q: float):
    """Sorted positions and f32 weights of ``jnp.quantile``'s linear
    interpolation over ``n`` values: ``(low, high, low_w, high_w)``."""
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low = np.floor(pos)
    high = np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(np.float32(1) - high_w)
    return (int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1)),
            low_w, high_w)


def _quantile_f32(flat: np.ndarray, q: float) -> np.float32:
    a = np.sort(flat.astype(np.float32))
    low, high, low_w, high_w = _quantile_weights(a.size, q)
    return np.float32(np.float32(a[low] * low_w) + np.float32(a[high] * high_w))


def _quantile_f32_torch(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``_quantile_f32`` on a tensor's device: the same sort and the same f32
    products and sum, each a separate op so nothing fuses into an FMA."""
    a = torch.sort(flat.float()).values
    low, high, low_w, high_w = _quantile_weights(a.numel(), q)
    return a[low] * float(low_w) + a[high] * float(high_w)


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero out the ``sparsity`` fraction of smallest-|w| entries."""
    w = np.asarray(w)
    if sparsity <= 0.0:
        return w
    thresh = _quantile_f32(np.abs(w).reshape(-1), sparsity)
    return np.where(np.abs(w) > thresh, w, np.zeros_like(w))


def block_prune(w: torch.Tensor, sparsity: float,
                block: Tuple[int, int]) -> torch.Tensor:
    """Prune a 2-D weight at tile granularity by tile L2 norm.

    The weight is padded up to a multiple of the block, each (bm, bn) tile
    scored by the f32 L2 norm of its entries, and every tile whose score is
    not strictly above the f32 ``sparsity`` quantile of the scores is zeroed
    whole (multiplied by 0, as the reference does).  Runs on ``w``'s device
    and returns a tensor of ``w``'s dtype and shape.
    """
    if sparsity <= 0.0:
        return w
    if w.ndim != 2:
        raise ValueError(f"block_prune expects 2-D weights, got shape "
                         f"{tuple(w.shape)}")
    bm, bn = block
    m, n = w.shape
    wp = torch.nn.functional.pad(w, (0, (-n) % bn, 0, (-m) % bm))
    gm, gn = wp.shape[0] // bm, wp.shape[1] // bn
    tiles = wp.reshape(gm, bm, gn, bn).permute(0, 2, 1, 3)  # (gm, gn, bm, bn)
    scores = torch.sqrt(torch.sum(torch.square(tiles.float()), dim=(2, 3)))
    keep = scores > _quantile_f32_torch(scores.reshape(-1), sparsity)
    tiles = tiles * keep[:, :, None, None].to(tiles.dtype)
    return tiles.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)[:m, :n]


def block_prune_conv(w, sparsity: float, block: Tuple[int, int]):
    """Prune an (M, C, R, S) filter bank at tile granularity.

    The bank is scored over its flattened (M, C*R*S) weight matrix, the
    layout :class:`~repro_torch.core.sparse_format.BcsrConv` blocks, so every
    surviving tile is one dense (bm, bn) tile of the BCSR conv kernel.  Same
    tile L2-norm rule as :func:`block_prune`.  A numpy bank comes back as
    numpy, a tensor as a tensor on its device.
    """
    if sparsity <= 0.0:
        return w
    if w.ndim != 4:
        raise ValueError(f"block_prune_conv expects 4-D filter banks, got "
                         f"shape {tuple(w.shape)}")
    if isinstance(w, np.ndarray):
        return block_prune_conv(torch.from_numpy(w), sparsity,
                                block).numpy()
    m = w.shape[0]
    return block_prune(w.reshape(m, -1), sparsity, block).reshape(w.shape)


def prune(w, cfg: SparsityConfig):
    """Prune ``w`` according to ``cfg`` (dispatching on method/structure):
    ``bcsr-mxu`` prunes tiles (2-D weights and 4-D filter banks), any other
    method magnitude-prunes (a numpy array)."""
    if not cfg.enabled or cfg.sparsity <= 0.0:
        return w
    if cfg.method == "bcsr-mxu" and w.ndim == 2:
        return block_prune(w, cfg.sparsity, cfg.block)
    if cfg.method == "bcsr-mxu" and w.ndim == 4:
        return block_prune_conv(w, cfg.sparsity, cfg.block)
    return magnitude_prune(w, cfg.sparsity)
