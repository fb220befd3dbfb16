"""Autograd-aware collectives over one named mesh dim.

The reference's ``shard_map`` bodies call ``lax.psum`` / ``lax.all_to_all``
and GSPMD inserts the rest; the port's meshed model runs on local shards
and calls these, each on the process group of one mesh dim
(``mesh.get_group(name)``), with its adjoint as the backward:

  all_reduce      sum            <-> all_reduce (sum)
  all_gather      cat along dim  <-> reduce_scatter along dim
  reduce_scatter  along dim      <-> all_gather along dim
  all_to_all      split dim 0    <-> all_to_all (its own inverse)

Every call is ``torch.distributed``'s eager collective (c10d), which runs on
NCCL and on gloo, CUDA tensors included (ranks that share one card use
gloo: NCCL refuses two ranks on one device).  A mesh dim of size 1 moves
nothing.  ``value_sum`` / ``value_max`` reduce a value over every mesh dim
outside autograd (metrics, norms, scales), ``value_min`` a value over
given mesh dims (the distributed argmax's first index).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as S


def _group(axis: str):
    return S.get_mesh().get_group(axis)


def _front(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.movedim(dim, 0).contiguous()


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = _front(t, dim)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = _front(t, dim)
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _a2a(t: torch.Tensor, group) -> torch.Tensor:
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


# Each Function keeps the process group it ran on for its backward: the
# active mesh is the calling thread's (``sharding.use_rules``), and the
# autograd engine runs a CUDA graph's backward on a thread of its own.

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis``'s ranks, on every one of them."""
    return x if S.axis_size(axis) == 1 else _AllReduce.apply(x, _group(axis))


def all_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    return (x if S.axis_size(axis) == 1
            else _AllGather.apply(x, dim, _group(axis)))


def reduce_scatter(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over ``axis``."""
    return (x if S.axis_size(axis) == 1
            else _ReduceScatter.apply(x, dim, _group(axis)))


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` (n * m, ...) split into n blocks along dim 0, block j sent to
    rank j; the received blocks in rank order."""
    return x if S.axis_size(axis) == 1 else _AllToAll.apply(x, _group(axis))


def _each_dim(t: torch.Tensor, op) -> torch.Tensor:
    mesh = S.get_mesh()
    for name in S._dim_names(mesh):
        if S.axis_size(name) > 1:
            t = _reduce(t, _group(name), op)
    return t


@torch.no_grad()
def value_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over every rank of the mesh (no autograd)."""
    return _each_dim(t, dist.ReduceOp.SUM)


def _over(t: torch.Tensor, axes, op) -> torch.Tensor:
    if axes is None:
        return _each_dim(t, op)
    for name in axes:
        if S.axis_size(name) > 1:
            t = _reduce(t, _group(name), op)
    return t


@torch.no_grad()
def value_max(t: torch.Tensor, axes=None) -> torch.Tensor:
    """Max of ``t`` over the given mesh dims (all by default)."""
    return _over(t, axes, dist.ReduceOp.MAX)


@torch.no_grad()
def value_min(t: torch.Tensor, axes=None) -> torch.Tensor:
    """Min of ``t`` over the given mesh dims (all by default)."""
    return _over(t, axes, dist.ReduceOp.MIN)
