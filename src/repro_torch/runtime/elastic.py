"""Elastic scaling: re-shard a checkpoint onto a different mesh.

Port of ``repro/runtime/elastic.py``.  Checkpoints store *global* leaves
(host files union to the full tensors) and placements are derived from
logical rules, so moving between mesh shapes is: build the new mesh ->
resolve specs -> restore with placement.  ``plan_remesh`` decides the
replacement mesh after losing ranks (drop the data-parallel extent first;
the model dim's extent is load-bearing for memory).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.launch.mesh import make_mesh


def plan_remesh(n_alive: int, *, model: int = 16,
                pod_axis: bool = False
                ) -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """Largest (data, model) mesh fitting the surviving ranks.

    Keeps the model dim fixed (the weights' sharding must still fit
    memory) and shrinks data parallelism to the largest power of two that
    fits.  Returns None if fewer than one model replica survives.
    """
    if n_alive < model:
        return None
    data = 1
    while data * 2 * model <= n_alive:
        data *= 2
    if pod_axis and data >= 2:
        return ((2, data // 2, model), ("pod", "data", "model"))
    return ((data, model), ("data", "model"))


def build_mesh(plan: Tuple[Tuple[int, ...], Tuple[str, ...]], *,
               device_type: Optional[str] = None):
    """The mesh of ``plan`` over the first ``prod(shape)`` ranks of the
    world (the others hold no coordinate on it)."""
    shape, axes = plan
    assert math.prod(shape) >= 1
    return make_mesh(tuple(shape), tuple(axes), device_type=device_type)
