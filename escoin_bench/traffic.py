"""The open-loop arrival schedule that the serving cells' data files
parametrise.

A schedule of a fixed rate holds exactly ``round(rate * seconds)``
requests.  Every seed gets the same set of gaps (the exponential
distribution's quantiles at the rate, scaled to fill the window) and the
same count of each image size, in another order, so the seed changes the
order of the work and not its amount; the order is Poisson-like, bursts
included.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from escoin_bench.weights import SEED_MOD


@dataclasses.dataclass(frozen=True)
class Arrival:
    rid: int
    t_s: float                      # due, from the schedule's start
    size: int                       # index into the cell's sizes
    image: int                      # index into that size's pool
    deadline_s: float


def open_loop(rate: float, seconds: float, sizes: List[int], per_size: int,
              deadline_s: float, seed: int, *,
              purpose: int = 4, first_rid: int = 0) -> List[Arrival]:
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng([seed % SEED_MOD, purpose])
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    size = rng.permutation(np.arange(n) % len(sizes))
    image = rng.integers(0, per_size, n)
    return [Arrival(rid=first_rid + i, t_s=float(due[i]),
                    size=int(size[i]), image=int(image[i]),
                    deadline_s=deadline_s) for i in range(n)]
