"""Int8 gradient compression for the cross-pod hop.

Port of ``repro/optim/compression.py``.  At 2-pod scale the pod dim
crosses hosts (much slower than the links inside a pod), so the cross-pod
gradient all-reduce is the term worth compressing:

  1. per-tensor symmetric int8 quantisation with an f32 scale,
  2. all-reduce of the int8 payload, summed as int32, over the pod group,
  3. dequantise with the pods' mean scale.

The train step (``launch/steps.py``, ``compress_cross_pod=True``) calls
``compressed_psum_tree`` after the full-precision reduction inside each
pod.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.tree import tree_map


def compress_int8(g: torch.Tensor, amax: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 payload, f32 scale).  ``amax``: the max |g| over the whole
    leaf where ``g`` is one shard of it (default: over ``g``)."""
    gf = g.float()
    if amax is None:
        amax = torch.amax(torch.abs(gf)) if gf.numel() else gf.new_zeros(())
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compressed_psum_tree(grads: Any, axis: str = "pod", *,
                         shard_axes: Any = None) -> Any:
    """Single-shot compressed mean over the mesh dim ``axis``, leaf by leaf:
    quantise, all-reduce the int8 payload as int32 (the sum cannot
    overflow), all-reduce the scales, dequantise the payload sum with the
    mean scale and divide by the number of ranks (the reference's
    ``compressed_psum_tree``).  ``shard_axes``: a tree like ``grads``
    holding, per leaf, the tuple of the other mesh dims the leaf is
    sharded over, whose max |g| makes the per-tensor scale (default: none,
    every leaf whole)."""
    n = S.axis_size(axis)
    group = S.get_mesh().get_group(axis)

    def one(g, axes: Sequence[str] = ()):
        gf = g.float()
        amax = torch.amax(torch.abs(gf)) if gf.numel() else gf.new_zeros(())
        q, scale = compress_int8(g, C.value_max(amax, axes))
        qs = q.to(torch.int32)
        ss = scale.clone()
        if n > 1:
            dist.all_reduce(qs, group=group)
            dist.all_reduce(ss, group=group)
        ss = ss / n
        return (qs.float() * ss / n).to(g.dtype)

    if shard_axes is None:
        return tree_map(one, grads)
    return tree_map(one, grads, shard_axes)
