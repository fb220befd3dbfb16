"""Magnitude weight pruning (Han et al. lineage, as used by the paper).

Port of ``repro/core/pruning.py:magnitude_prune``, on the host in numpy:
the weights are drawn on the host and pruned before any format is built.
The threshold repeats ``jnp.quantile``'s linear interpolation in float32
(sort, ``q * (n - 1)``, floor/ceil weights, ``lo * w_lo + hi * w_hi``), so the
kept mask matches the reference's up to ties at the threshold.
"""
from __future__ import annotations

import numpy as np


def _quantile_f32(flat: np.ndarray, q: float) -> np.float32:
    a = np.sort(flat.astype(np.float32))
    n = np.float32(a.size)
    pos = np.float32(q) * (n - np.float32(1))
    low = np.floor(pos)
    high = np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(np.float32(1) - high_w)
    lo = a[int(min(max(low, 0), a.size - 1))]
    hi = a[int(min(max(high, 0), a.size - 1))]
    return np.float32(np.float32(lo * low_w) + np.float32(hi * high_w))


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero out the ``sparsity`` fraction of smallest-|w| entries."""
    w = np.asarray(w)
    if sparsity <= 0.0:
        return w
    thresh = _quantile_f32(np.abs(w).reshape(-1), sparsity)
    return np.where(np.abs(w) > thresh, w, np.zeros_like(w))
