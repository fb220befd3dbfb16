"""Mesh constructors.  Port of ``repro/launch/mesh.py`` on ``DeviceMesh``.

``make_production_mesh`` is a function (importing this module touches no
process group).  Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod:
2 x 16 x 16 = 512 ranks (pod, data, model); the pod dim crosses hosts.
Each needs a process group (``torch.distributed``) whose world
holds the mesh's ranks; ranks past the mesh's size are left out of it (as
the reference takes the first devices of a larger set).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"need {need} ranks for mesh {shape}, have {have} — launch the "
            f"world with torchrun --nproc-per-node (or across nodes) first")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks of the world, row major
    (elastic re-mesh / tests)."""
    need = math.prod(shape)
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=tuple(axes))


def make_host_mesh(model: Optional[int] = None, *,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """Every rank of the world as (data, model).  On the card a run has one
    rank a GPU (``torchrun --nproc-per-node $(nvidia-smi -L | wc -l)``)."""
    n = dist.get_world_size()
    model = model or 1
    assert n % model == 0, (n, model)
    return make_mesh((n // model, model), ("data", "model"),
                     device_type=device_type)
