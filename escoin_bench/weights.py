"""Seeded weights and inputs, made on the device in a few large calls.

The formulas follow the port's CNN init (He-normal conv weights,
``sqrt(2 / fan_in)``; unstructured magnitude pruning at each layer's rate,
zeroing every weight whose magnitude is not above the rate's quantile of
the layer's magnitudes, the quantile linearly interpolated as
``numpy.quantile`` does) and add a small seeded bias, so the comparison
covers the bias in every conv's epilogue.  The same arrays go to the port
and to the reference; nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BIAS_SCALE = 0.05
SEED_MOD = 2 ** 63


def stream(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose (weights, inputs, ...) of a run."""
    state = np.random.SeedSequence([seed % SEED_MOD, purpose]).generate_state(
        1, np.uint64)
    return int(state[0]) % SEED_MOD


def generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, purpose))
    return g


def magnitude_threshold(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """The ``sparsity`` quantile of ``|w|``, linearly interpolated."""
    a = torch.sort(w.abs().reshape(-1)).values
    pos = sparsity * (a.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, a.numel() - 1)
    frac = pos - lo
    return a[lo] * (1.0 - frac) + a[hi] * frac


def conv_weights(convs: Sequence[Dict], seed: int, device,
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """``{name: (w, b)}`` for every conv, pruned at its rate: one normal
    draw for all the weights and one for all the biases."""
    g = generator(seed, 0, device)
    sizes = [c["m"] * c["c"] * c["k"] * c["k"] for c in convs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    bias = torch.randn(sum(c["m"] for c in convs), generator=g,
                       device=device) * BIAS_SCALE
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    o = ob = 0
    for c, n in zip(convs, sizes):
        w = flat[o:o + n].view(c["m"], c["c"], c["k"], c["k"])
        w = w * (2.0 / (c["c"] * c["k"] * c["k"])) ** 0.5
        if c["sparsity"] > 0:
            w = torch.where(w.abs() > magnitude_threshold(w, c["sparsity"]),
                            w, torch.zeros_like(w))
        out[c["name"]] = (w.contiguous(), bias[ob:ob + c["m"]].contiguous())
        o += n
        ob += c["m"]
    return out


def fc_seed(seed: int) -> int:
    """The seed of the FC weights' numpy stream (the port's ``_fc_rng``)."""
    return stream(seed, 1) % 2 ** 31


def image_batches(n: int, batch: int, shape: Tuple[int, int, int],
                  seed: int, device) -> torch.Tensor:
    """(n, batch, C, H, W) standard-normal images, one draw."""
    g = generator(seed, 2, device)
    return torch.randn((n, batch) + tuple(shape), generator=g, device=device)


def image_pool(sizes: Sequence[int], per_size: int, channels: int,
               seed: int) -> List[List[np.ndarray]]:
    """``per_size`` standard-normal host images of each square size."""
    rng = np.random.default_rng([seed % SEED_MOD, 3])
    return [list(rng.standard_normal((per_size, channels, s, s))
                 .astype(np.float32)) for s in sizes]


def padded_pool(pool: Sequence[Sequence[np.ndarray]], sizes: Sequence[int],
                buckets: Sequence[int]) -> List[torch.Tensor]:
    """Each size's pool images zero-padded into the smallest bucket that
    holds them, as the serving tier pads a request: one (n, C, B, B)
    tensor a size."""
    out = []
    for images, s in zip(pool, sizes):
        b = min(x for x in buckets if x >= s)
        x = torch.zeros((len(images), images[0].shape[0], b, b))
        x[:, :, :s, :s] = torch.from_numpy(np.stack(images))
        out.append(x)
    return out
