"""Escoin-BCSR weight trees for meshed serving, and the dry run's abstract
ones (§Perf C).

Port of ``repro/launch/sparse_weights.py``.  At decode the weight bytes are
the HBM-traffic floor; Escoin's thesis is that pruning should buy speed,
not just space.  ``abstract_sparse_params`` rewrites the parameter tree so
every large projection is a ``BcsrMatrix`` whose tile count reflects the
target sparsity: the serving step then reads 1 - sparsity of the weight
bytes, and the dry run's memory term shows the win that real pruned
serving gets.  No weight values exist on ``meta``: a block-row keeps the
deterministic ``ceil(gn * (1 - sparsity))`` tiles.

The tree is the port's per-layer layout.  Its converted leaves are the
reference's (``SKIP``, its 2-D rule, and its layer-stacked 3-D rule read
on the reference's stacked shape of each per-layer leaf); a MoE layer's
(E, in, out) experts, 4-D in the reference's stack, stay dense.

Block geometry, the reference's (``reference_block``, its
``_abstract_bcsr``): bm = M / tp where tp divides M and M / tp >= 8, else
M; bn = 128 where 128 divides N, else N, for the logical (M, N) = (out, in)
weight.  The port's leaf is the BCSR of W^T of this rank's own ``tp``
shard (whole over every other mesh dim, as the reference's sparse specs
leave its blocks) in those blocks: what the port's mesh path runs ("only
as whole shards", ``layers._use``), and where tp splits M, the reference's
own leaf's block-row of this rank.  The card's kernel takes any block
whose sides are multiples of 16 as it is, and ``ops.bsr_matmul`` re-tiles
any other.

``sparsify_shards`` does the same to real placed weights: each rank prunes
its own ``tp`` shard (gathered over the other mesh dims) in the same
blocks, tile by tile of its bank (``serve.prune_to_bcsr``).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.distributed import sharding as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_flatten, tree_map, tree_paths

SKIP = frozenset({"embed", "lm_head", "router", "conv_w", "q_norm",
                  "kv_norm"})


def reference_block(m: int, n: int, tp: int) -> Tuple[int, int]:
    """The reference's block for a logical (M, N) = (``m``, ``n``) weight
    over ``tp`` ranks: one block-row a rank where tp divides M into rows of
    at least 8, else the whole M; 128 columns where 128 divides N, else
    the whole N."""
    bm = m // tp if (m % tp == 0 and m // tp >= 8) else m
    bn = 128 if n % 128 == 0 else n
    return bm, bn


def reference_shape(cfg: ModelConfig, path: str, shape) -> Tuple[int, ...]:
    """The shape the reference's tree gives the leaf at the port's
    ``path``: a layer past the unrolled prefix sits in the scanned stack,
    with the stack's leading block dim."""
    parts = path.split("/")
    if parts[0] != "layers":
        return tuple(shape)
    prefix, _, nblocks = T.stage_plan(cfg)
    return ((nblocks,) if int(parts[1]) >= len(prefix) else ()) + tuple(
        shape)


def converts(cfg: ModelConfig, path: str, shape, min_dim: int = 512) -> bool:
    """Whether the reference's ``abstract_sparse_params`` makes the leaf at
    ``path`` a BCSR leaf: not in ``SKIP``, and 2-D with both dims at least
    ``min_dim``, or layer-stacked 3-D with both matrix dims at least it."""
    name = path.split("/")[-1]
    ref = reference_shape(cfg, path, shape)
    if name in SKIP:
        return False
    return ((len(ref) == 2 and min(ref) >= min_dim)
            or (len(ref) == 3 and min(ref[1:]) >= min_dim))


def _tp_shard_shape(shape, pls, mesh) -> Tuple[int, ...]:
    """``shape`` cut along the dim the "tp" mesh dim shards (if any)."""
    out = list(shape)
    ax = S.tp_axis()
    names = S._dim_names(mesh)
    if ax is not None:
        pl = pls[names.index(ax)]
        if isinstance(pl, Shard):
            out[pl.dim] //= S.axis_size(ax, mesh)
    return tuple(out)


def whole_but_tp(pls, mesh) -> tuple:
    """Placements ``pls`` with every mesh dim but "tp" made Replicate."""
    ax = S.tp_axis()
    names = S._dim_names(mesh)
    return tuple(pl if names[i] == ax else Replicate()
                 for i, pl in enumerate(pls))


def _bcsr(m: int, n: int, block: Tuple[int, int], sparsity: float, dtype,
          device, gen: Optional[torch.Generator]) -> BcsrMatrix:
    """A BCSR (M, N) weight of ``block`` tiles keeping ceil(gn * (1 -
    sparsity)) tiles in every block-row: empty without ``gen`` (``meta``),
    else tiles drawn from ``gen`` (truncated normal x N**-0.5) at block
    columns drawn ascending."""
    bm, bn = block
    gm, gn = -(-m // bm), -(-n // bn)
    kb = max(1, math.ceil(gn * (1.0 - sparsity)))
    if gen is None:
        return BcsrMatrix(
            blocks=torch.empty((gm, kb, bm, bn), dtype=dtype, device=device),
            blockcol=torch.empty((gm, kb), dtype=torch.int32, device=device),
            nblocks=torch.empty((gm,), dtype=torch.int32, device=device),
            shape=(m, n), block=tuple(block))
    from repro_torch.models.layers import truncated_normal
    cols = torch.rand((gm, gn), generator=gen).argsort(dim=1)[:, :kb]
    return BcsrMatrix(
        blocks=(truncated_normal((gm, kb, bm, bn), gen, device)
                * n ** -0.5).to(dtype),
        blockcol=cols.sort(dim=1).values.to(torch.int32).to(device),
        nblocks=torch.full((gm,), kb, dtype=torch.int32, device=device),
        shape=(m, n), block=tuple(block))


def abstract_sparse_params(cfg: ModelConfig, tp: int, sparsity: float,
                           min_dim: int = 512, *, mesh=None,
                           device="meta",
                           gen: Optional[torch.Generator] = None
                           ) -> Tuple[Any, Any]:
    """(param tree, placements tree) on ``mesh`` (the active one), under the
    active rules.  The tree is ``T.init_params``' on ``meta`` (shapes and
    dtypes, no storage) with each leaf that ``converts`` replaced by the
    ``BcsrMatrix`` of W^T of this rank's ``tp`` shard (in the
    ``reference_block`` of the whole weight over ``tp``);
    the placements are ``param_specs``' with a converted leaf's mesh dims
    other than "tp" made Replicate (the dense shard its BCSR encodes).
    Dense leaves are whole, for ``steps.place_state``; BCSR leaves are
    this rank's already.  With a ``device`` and ``gen`` (tests of the
    counts on real tensors) the values are drawn: ``init_params``' and
    ``_bcsr``'s."""
    mesh = mesh if mesh is not None else S.get_mesh()
    dense = T.init_params(cfg, gen if gen is not None
                          else torch.Generator().manual_seed(0), device)
    pls = tree_map(lambda s: S.placements(s, mesh), T.param_specs(cfg, tp))
    out_leaves, out_pls = [], []
    pl_by_path = dict(tree_paths(pls))
    for path, w in tree_paths(dense):
        pl = pl_by_path[path]
        if not converts(cfg, path, w.shape, min_dim):
            out_leaves.append(w)
            out_pls.append(pl)
            continue
        if w.ndim != 2:
            raise NotImplementedError(
                f"{cfg.name}: {path}: the reference converts this "
                f"{w.ndim}-D leaf as a layer stack; the port's BCSR leaves "
                f"are 2-D")
        n_in, n_out = _tp_shard_shape(w.shape, pl, mesh)
        block = reference_block(w.shape[1], w.shape[0], tp)
        out_leaves.append(_bcsr(n_out, n_in, block, sparsity, w.dtype,
                                device, gen))
        out_pls.append(whole_but_tp(pl, mesh))
    return tree_flatten(dense)[1](out_leaves), tree_flatten(pls)[1](out_pls)


def sparsify_shards(params: Any, cfg: ModelConfig, sparsity: float, *,
                    min_dim: int = 64) -> Any:
    """Placed params (DTensors, ``steps.place_state``) with every leaf that
    ``serve.sparsify_params`` converts (its ``SKIP``, 2-D leaves whose shard
    has both dims at least ``min_dim``) replaced by the BCSR of this rank's
    pruned ``tp`` shard in the ``reference_block`` of the whole weight over
    the mesh's tp ranks: the shard gathered over the other mesh dims, then
    pruned and converted by ``serve.prune_to_bcsr`` with every pruned tile
    a whole tile of the bank.  The other leaves are returned as they are.
    Under the mesh's rules."""
    from repro_torch.launch.serve import SKIP as SERVE_SKIP, prune_to_bcsr

    mesh = S.get_mesh()
    tp = S.tp_size()

    def one(path, w):
        name = path.split("/")[-1]
        if not isinstance(w, DTensor) or w.ndim != 2 or name in SERVE_SKIP:
            return w
        if min(_tp_shard_shape(w.shape, w.placements, mesh)) < min_dim:
            return w
        shard = S.redistribute(w, whole_but_tp(w.placements, mesh))
        return prune_to_bcsr(shard.to_local(), sparsity,
                             reference_block(w.shape[1], w.shape[0], tp),
                             whole_tiles=True)

    return tree_flatten(params)[1]([one(k, w) for k, w in tree_paths(params)])
