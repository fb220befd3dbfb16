"""The steps (train_step / prefill_step / serve_step) and the state's
placements on a mesh.

Port of ``repro/launch/steps.py``.  The steps run eagerly on whatever
device the params and inputs are on; ``serve_step`` updates the cache in
place (the reference donates it to the jitted step).  ``train_step`` takes
gradients with ``loss.backward()`` on the params, set to
``requires_grad_()`` for the step, where the reference takes
``jax.value_and_grad``.

On a mesh (inside ``sharding.use_rules``): ``state_placements`` gives each
leaf its DTensor placements (params and both moments by ``param_specs``,
the step replicated), ``place_state`` / ``place_batch`` / ``place_cache``
put whole tensors (drawn from one seed on every rank) on the mesh, and
``train_step`` on a DTensor state runs the meshed model on each rank's
shards, then sums each gradient over the mesh dims its leaf is replicated
on (in-pod dims at full precision; the "pod" dim through the int8
all-reduce under ``compress_cross_pod``), takes the global norm and
updates the shards in place.  ``serve_step`` on DTensor tokens, placed
params and a placed cache runs the meshed decode and a distributed argmax
(``mesh_argmax``).

Distributed-optimisation knobs (the reference's):
  * num_microbatches > 1     -- gradient accumulation;
  * compress_cross_pod=True  -- int8 all-reduce over the "pod" dim
                                (``optim/compression.py``); a no-op
                                without a pod dim, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.optim.compression import compressed_psum_tree
from repro_torch.tree import tree_flatten, tree_map, tree_paths


def state_placements(cfg: ModelConfig, mesh, tp: int) -> Dict[str, Any]:
    """The train state's tree with each leaf's DTensor placements on
    ``mesh`` (the reference's ``state_shardings``), under the active
    rules."""
    params = tree_map(lambda s: S.placements(s, mesh), T.param_specs(cfg, tp))
    return {"params": params,
            "opt": {"m": params, "v": params,
                    "step": S.placements(P(), mesh)}}


def place_state(state: Any, placements: Any, mesh=None) -> Any:
    """Whole leaves (the same on every rank) as DTensors of this rank's
    chunks, each by the placements at its tree path (the trees' key orders
    may differ); no data moves between ranks.  A ``BcsrMatrix`` leaf is
    already this rank's own (``sparse_weights``) and stays as it is."""
    pls = dict(tree_paths(placements))
    return tree_flatten(state)[1]([
        S.distribute(t, pls[k], mesh) if isinstance(t, torch.Tensor) else t
        for k, t in tree_paths(state)])


def cache_placements(cfg: ModelConfig, batch: int, mesh, tp: int) -> Any:
    """The cache's tree with each leaf's placements: ``T.cache_specs``, the
    batch dim left whole where "dp" does not divide ``batch``
    (``specs.decode_input_specs``'s rule)."""
    from repro_torch.launch import specs
    parts = T.cache_specs(cfg, tp)
    dp = 1
    for a in S._axes(S.resolve(P("dp"))[0]):
        dp *= S.axis_size(a, mesh)
    if batch % dp:
        parts = specs._drop_batch_axis(parts)
    return tree_map(lambda s: S.placements(s, mesh), parts)


def place_cache(cache: Any, cfg: ModelConfig, mesh, tp: int) -> Any:
    """A whole cache (``T.init_cache``, the same on every rank) as DTensors
    of this rank's chunks, by ``cache_placements``; the meshed decode
    updates their local tensors in place."""
    batch = tree_flatten(cache)[0][0].shape[0]
    return place_state(cache, cache_placements(cfg, batch, mesh, tp), mesh)


def place_tokens(tokens, device, mesh=None) -> DTensor:
    """Decode tokens (B, 1) (numpy or a tensor, the same on every rank) as a
    DTensor, the batch over "dp" where it divides, else whole."""
    mesh = mesh if mesh is not None else S.get_mesh()
    t = _on(tokens, device)
    return S.distribute(t, S.placements(P("dp", None), mesh, tuple(t.shape)),
                        mesh)


def place_batch(batch: Dict[str, Any], device, mesh=None) -> Dict[str, Any]:
    """A global batch (numpy or tensors, the same on every rank) as
    DTensors with the batch dim over "dp" (as the reference's training
    CLI places it); the batch must split evenly."""
    mesh = mesh if mesh is not None else S.get_mesh()
    out = {}
    for k, v in batch.items():
        t = _on(v, device)
        out[k] = S.distribute(t, S.placements(P("dp"), mesh), mesh)
    return out


def _on(x, device) -> torch.Tensor:
    """A batch entry (numpy or tensor) as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def loss_and_grads(cfg: ModelConfig, params, batch
                   ) -> Tuple[torch.Tensor, list]:
    """(``loss_fn`` on ``batch``, [its gradient for each leaf of ``params``
    in walk order]), by ``loss.backward()`` with the leaves set to
    ``requires_grad_()`` for the call; ``batch`` holds tensors on the
    params' device."""
    leaves, _ = tree_flatten(params)
    for p in leaves:
        p.requires_grad_()
    try:
        loss = T.loss_fn(params, batch.get("tokens"), batch["labels"], cfg,
                         embeds=batch.get("embeds"))
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    num_microbatches: int = 1,
                    compress_cross_pod: bool = False,
                    total_steps: int = 100_000,
                    ) -> Callable[..., Tuple[Dict, Dict]]:
    """Returns train_step(state, batch) -> (state, metrics).  ``batch``
    holds ``tokens`` (or ``embeds``) and ``labels`` as numpy arrays or
    tensors; with ``num_microbatches`` > 1 they are split along the batch
    axis, the gradients summed in f32 and scaled by 1 / num_microbatches.
    The caller gives the state up, as the reference's launchers donate it
    to the jitted step: the step writes the update into its tensors
    (``adamw_update``) and returns them.  A state of DTensors
    (``place_state``) takes the meshed step (the module's docstring), with
    ``metrics["loss"]`` the global loss."""

    def grads_of(params, batch):
        if num_microbatches == 1:
            return loss_and_grads(cfg, params, batch)
        n = num_microbatches
        b = _local(batch["labels"]).shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        loss_sum, g_acc = 0.0, None
        for i in range(n):
            mb = {k: _rows(v, i * (b // n), (i + 1) * (b // n))
                  for k, v in batch.items()}
            loss, g = loss_and_grads(cfg, params, mb)
            loss_sum = loss_sum + loss
            g32 = [x.float() for x in g]
            g_acc = g32 if g_acc is None else [a + x for a, x in
                                               zip(g_acc, g32)]
        inv = 1.0 / n
        return loss_sum * inv, [g * inv for g in g_acc]

    def mesh_step(state, batch):
        params, opt = state["params"], state["opt"]
        mesh = S.get_mesh()
        dev = opt["step"].to_local().device
        if not all(isinstance(v, DTensor) for v in batch.values()):
            batch = place_batch(batch, dev, mesh)
        leaves, rebuild = tree_flatten(params)
        with torch.no_grad():
            local = rebuild([x.to_local() for x in leaves])
            m = tree_map(lambda x: x.to_local(), opt["m"])
            v = tree_map(lambda x: x.to_local(), opt["v"])
            step = opt["step"].to_local()
        loss, flat_grads = grads_of(local, batch)
        pls = [x.placements for x in leaves]
        flat_grads = reduce_grads(flat_grads, pls, mesh, compress_cross_pod)
        gnorm = mesh_norm(flat_grads, pls, mesh)
        lr = cosine_schedule(step, peak=opt_cfg.lr,
                             warmup=min(2000, max(1, total_steps // 10)),
                             total=total_steps)
        _, new_opt, gnorm = adamw_update(
            local, rebuild(flat_grads), {"m": m, "v": v, "step": step},
            opt_cfg, lr, gnorm=gnorm)
        with torch.no_grad():
            step.copy_(new_opt["step"])
        metrics = {"loss": C.value_sum(loss.detach()), "grad_norm": gnorm,
                   "lr": lr, "step": new_opt["step"]}
        return state, metrics

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        if isinstance(opt["step"], DTensor):
            return mesh_step(state, batch)
        dev = opt["step"].device
        batch = {k: _on(v, dev) for k, v in batch.items()}
        loss, flat_grads = grads_of(params, batch)
        grads = tree_flatten(params)[1](flat_grads)
        lr = cosine_schedule(opt["step"], peak=opt_cfg.lr,
                             warmup=min(2000, max(1, total_steps // 10)),
                             total=total_steps)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt,
                                                  opt_cfg, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": new_opt["step"]}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def reduce_grads(grads: list, pls: list, mesh,
                 compress_cross_pod: bool = False) -> list:
    """Each rank's gradients of its disjoint part of the loss -> the
    global gradient's shards (each leaf's ``pls``): summed over the mesh
    dims each leaf is replicated on.  With ``compress_cross_pod`` and a
    "pod" dim, the sum stays at full precision inside each pod, then each
    pod's own mean gradient (its sum times the pod count) goes through
    ``compressed_psum_tree``, whose mean over the pods is the global
    gradient within int8 rounding."""
    has_pod = compress_cross_pod and "pod" in S._dim_names(mesh)
    grads = _sum_replicated(list(grads), pls, mesh,
                            skip=("pod",) if has_pod else ())
    if not has_pod:
        return grads
    n_pod = S.axis_size("pod", mesh)
    return compressed_psum_tree([g * n_pod for g in grads], "pod",
                                shard_axes=shard_axes(pls, mesh))


def shard_axes(pls: list, mesh) -> list:
    """For each leaf's placements, the mesh dims it is sharded over."""
    names = S._dim_names(mesh)
    return [tuple(names[i] for i, p in enumerate(pl) if isinstance(p, Shard))
            for pl in pls]


def mesh_norm(grads: list, pls: list, mesh) -> torch.Tensor:
    """The global norm of gradient shards with placements ``pls``: each
    shard counted once, by its first holder (``_owns``)."""
    dev = grads[0].device
    return torch.sqrt(C.value_sum(sum(
        (torch.sum(torch.square(g.float()))
         for g, pl in zip(grads, pls) if _owns(pl, mesh)),
        torch.zeros((), device=dev))))


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _rows(x, lo: int, hi: int):
    """Rows lo:hi of a batch entry; of a DTensor, of its local shard."""
    if isinstance(x, DTensor):
        return S.map_local(lambda t: t[lo:hi], x)
    return x[lo:hi]


def _owns(pls, mesh) -> bool:
    """Whether this rank counts a leaf's shard in the global norm: the
    first of the ranks that hold the same shard (coordinate 0 on every
    mesh dim the leaf is replicated on)."""
    return all(mesh.get_local_rank(i) == 0 for i, pl in enumerate(pls)
               if isinstance(pl, Replicate))


@torch.no_grad()
def _sum_replicated(grads: list, pls: list, mesh, skip=()) -> list:
    """Each gradient summed over the mesh dims its leaf is replicated on
    (every rank's gradient is its disjoint part of the loss's), but the
    dims in ``skip``: one all-reduce a mesh dim and dtype, over the
    gradients concatenated."""
    names = S._dim_names(mesh)
    for i, name in enumerate(names):
        if name in skip or mesh.size(i) == 1:
            continue
        todo = [j for j, pl in enumerate(pls) if isinstance(pl[i], Replicate)]
        for dt in sorted({grads[j].dtype for j in todo}, key=str):
            js = [j for j in todo if grads[j].dtype == dt]
            flat = torch.cat([grads[j].reshape(-1) for j in js])
            dist.all_reduce(flat, group=mesh.get_group(name))
            for j, part in zip(js, flat.split([grads[j].numel()
                                               for j in js])):
                grads[j] = part.view_as(grads[j])
    return grads


def init_state(cfg: ModelConfig, opt_cfg: AdamWConfig, gen: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    params = T.init_params(cfg, gen, device)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def abstract_state(cfg: ModelConfig, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """The train state's tensors on the ``meta`` device: shapes and dtypes,
    no storage (the reference's ``jax.eval_shape``)."""
    return init_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "meta")


def state_from_reference(np_state: Dict[str, Any], cfg: ModelConfig,
                         device="cuda") -> Dict[str, Any]:
    """The reference's train state ``{"params", "opt": {"m", "v", "step"}}``
    (leaves as numpy arrays) as the port's.  The moments are unstacked as
    the params are (``params_from_reference``) and keep their own dtype."""
    dev = resolve_device(device)
    opt = np_state["opt"]
    return {"params": T.params_from_reference(np_state["params"], cfg, dev),
            "opt": {"m": T.params_from_reference(opt["m"], cfg, dev),
                    "v": T.params_from_reference(opt["v"], cfg, dev),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(params, batch) -> (last-position logits (B, V), final
    hidden (B, T, D)).  ``batch`` holds ``tokens`` (B, T) or ``embeds``
    (B, T, D); on a mesh, DTensors (``place_batch``), the params placed
    (``place_state``) or local shards, and the results DTensors (the
    logits' vocabulary over "tp")."""

    def prefill_step(params, batch):
        if isinstance(next(iter(batch.values())), DTensor):
            params = T.local_shards(params)
        if "embeds" in batch:
            h, _ = T.hidden_embeds(params, batch["embeds"], cfg)
        else:
            h, _ = T.hidden_embeds(params, T.embed(params, batch["tokens"],
                                                   cfg), cfg)
        if isinstance(h, DTensor):
            # the last position of the whole sequence, batch over "dp"
            last = S.map_local(lambda x: x[:, -1:],
                               S.constrain(h, "dp", None, None))
            return T.last_position(T._head(params, cfg, last)), h
        logits = T._head(params, cfg, h[:, -1:])
        return logits[:, 0], h

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, tokens (B, 1), cache, cur_len) -> (next token ids
    (B,) int32, cache), the cache updated in place; ``cur_len`` a host int.
    On a mesh (DTensor tokens, ``place_cache``'s cache, placed params or
    ``sparse_weights``' trees): the next tokens a DTensor over "dp", as the
    reference's ``out_shardings``."""

    def serve_step(params, tokens, cache, cur_len):
        logits, cache = T.decode_step(params, cfg, tokens, cache, cur_len)
        if isinstance(logits, DTensor):
            return mesh_argmax(logits), cache
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


@torch.no_grad()
def mesh_argmax(logits: DTensor) -> DTensor:
    """``torch.argmax(logits, -1)`` (int32) of DTensor logits (B, V) whose
    vocabulary may be split over "tp": each rank's first maximal index, the
    maximum over "tp", then the least global index among the ranks that
    hold it, so ties across ranks give the first maximal index, as
    ``jnp.argmax`` and ``torch.argmax`` do.  The result keeps the batch's
    placements and is whole over the vocabulary's."""
    local = logits.to_local()
    idx = torch.argmax(local, dim=-1)
    names = S._dim_names(logits.device_mesh)
    pls = list(logits.placements)
    for i, pl in enumerate(pls):
        if not (isinstance(pl, Shard) and pl.dim == local.ndim - 1):
            continue
        ax = names[i]
        val = torch.gather(local, -1, idx[..., None])[..., 0]
        idx = idx + S.axis_index(ax, logits.device_mesh) * local.shape[-1]
        top = C.value_max(val, [ax])
        idx = C.value_min(torch.where(val == top, idx,
                                      torch.full_like(idx, torch.iinfo(
                                          idx.dtype).max)), [ax])
        pls[i] = Replicate()
    return S.wrap(idx.to(torch.int32), pls)
