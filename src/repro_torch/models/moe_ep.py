"""Expert-parallel MoE with explicit all-to-all dispatch.

Port of ``repro/models/moe_ep.py``.  The gather dispatch routes every token
of the batch on every rank; real expert-parallel systems move tokens with
an all-to-all whose volume is the activation bytes x top_k, independent of
the expert count.  Over the mesh's ``tp`` dim (each rank owns E / tp
experts):

  1. route locally: top-k experts per local token;
  2. bucket the (token, k) assignments by destination rank into send
     buffers of fixed capacity ``cap_rank`` (overflow drops, like the
     capacity semantics of the gather path);
  3. all-to-all the (tp, cap_rank, D) buffer (and each slot's expert id);
  4. group the received tokens by local expert into second-level buffers
     of capacity ``cap_exp`` (overflow drops), run the expert FFN;
  5. all-to-all back and combine with the router weights.

Everything is gathers, sorts and all-to-alls: the backward is the mirrored
all-to-all (``collectives.all_to_all``'s adjoint), not a replicated
scatter-add.  A rank's tokens are its batch shard over the mesh's other
dims and its sequence shard over ``tp``; the router is whole on every
rank, the experts are its own (E / tp) gathered over "fsdp".

``count_drops()`` collects, per call, the assignments each level dropped
(a read-back per call, for tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_DROPS: Optional[List[int]] = None


@contextlib.contextmanager
def count_drops():
    """Within the block, every ``_bucket_by`` appends the number of items
    its buckets dropped (real items over capacity, not the empty slots of
    a received buffer) to the list this yields."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _bucket_by(dest: torch.Tensor, n_buckets: int, capacity: int):
    """dest: (N,) bucket ids -> (slot (N,), token_for_slot
    (n_buckets * capacity,)).

    slot[i] = the global slot of item i (bucket * capacity + pos), at least
    n_buckets * capacity where its bucket overflowed; token_for_slot
    inverts it (sentinel N for an empty slot).  Ids past the last bucket
    (the sentinel bucket of a received buffer's empty slots) are bucketed
    as the reference's clamped gathers and dropped scatters place them.
    """
    n = dest.shape[0]
    dev = dest.device
    order = torch.argsort(dest, stable=True)
    sorted_d = dest[order]
    start = torch.searchsorted(sorted_d, torch.arange(n_buckets, device=dev),
                               side="left")
    pos = torch.arange(n, device=dev) - start[sorted_d.clamp(max=n_buckets - 1)]
    ok = pos < capacity
    trash = n_buckets * capacity
    slot_sorted = torch.where(ok, sorted_d * capacity + pos,
                              torch.full_like(pos, trash))
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    token_for_slot = torch.full((trash + 1,), n, dtype=torch.int64,
                                device=dev)
    # the reference's mode="drop": slots past the trash slot land in it
    # too (a scatter, not a masked assignment: no read-back of the mask,
    # so the dry run's meta tensors take it)
    token_for_slot.scatter_(0, slot_sorted.clamp(max=trash), order)
    if _DROPS is not None:
        _DROPS.append(int(((sorted_d < n_buckets) & ~ok).sum()))
    return slot, token_for_slot[:-1]


def _ep_local(p: Params, xg: torch.Tensor, cfg: ModelConfig, *, ax: str,
              tp: int, cap_rank: int, cap_exp: int) -> torch.Tensor:
    """One rank's part.  xg: (n_loc, D) local tokens -> (n_loc, D)."""
    n, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // tp

    logits = torch.matmul(xg.float(), p["router"].float())
    topw, topi = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(-1)                                # (n*k,)
    slot, tok4slot = _bucket_by(flat_e // e_loc, tp, cap_rank)
    xpad = torch.cat([xg, xg.new_zeros((1, d))], dim=0)
    valid = tok4slot < n * k
    send = xpad[torch.clamp(tok4slot // k, max=n)].reshape(tp, cap_rank, d)
    send = torch.where(valid.reshape(tp, cap_rank, 1), send,
                       torch.zeros_like(send))
    # also ship each slot's (global) expert id
    send_eid = torch.where(valid, flat_e[torch.clamp(tok4slot, max=n * k - 1)],
                           torch.full_like(tok4slot, -1))

    recv = C.all_to_all(send.reshape(tp * cap_rank, d), ax)
    with torch.no_grad():
        recv_eid = C.all_to_all(send_eid, ax)
    loc_eid = torch.where(recv_eid >= 0, recv_eid % e_loc,
                          torch.full_like(recv_eid, e_loc))  # sentinel bucket

    # second level: received tokens -> local expert capacity buffers
    slot2, tok4slot2 = _bucket_by(loc_eid, e_loc, cap_exp)
    rpad = torch.cat([recv, recv.new_zeros((1, d))], dim=0)
    xe = rpad[torch.clamp(tok4slot2, max=tp * cap_rank)].reshape(
        e_loc, cap_exp, d)
    y = L.experts_fwd(p, xe, xe.dtype)

    # invert level 2: per received slot, then the return trip
    ypad = torch.cat([y.reshape(e_loc * cap_exp, d), y.new_zeros((1, d))], 0)
    y_recv = ypad[torch.clamp(slot2, max=e_loc * cap_exp)]   # (tp*cap, d)
    y_send = C.all_to_all(y_recv, ax)
    # invert level 1: per (token, k)
    ypad1 = torch.cat([y_send, y_send.new_zeros((1, d))], dim=0)
    per_k = ypad1[torch.clamp(slot, max=tp * cap_rank)].reshape(n, k, d)
    return torch.einsum("gk,gkd->gd", topw.float(),
                        per_k.float()).to(xg.dtype)


def ep_capacities(cfg: ModelConfig, b: int, t: int, dp_total: int,
                  tp: int, cf: float):
    """(n_loc, cap_rank, cap_exp) of the reference for a (b, t) batch."""
    n_loc = max(1, b * t // (dp_total * tp))
    cap_rank = max(8, int(n_loc * cfg.top_k / tp * cf) // 8 * 8)
    cap_exp = max(8, int(tp * cap_rank / (cfg.n_experts // tp) * cf) // 8 * 8)
    return n_loc, cap_rank, cap_exp


def moe_fwd_ep(p: Params, x: DTensor, cfg: ModelConfig) -> DTensor:
    """Drop-in for ``layers.moe_fwd`` on a mesh whose ``tp`` dim divides
    the experts: x (B, T, D) a DTensor -> the MoE output in x's
    placements."""
    mesh = S.get_mesh()
    ax = S.tp_axis()
    assert ax is not None
    tp = S.axis_size(ax)
    assert cfg.n_experts % tp == 0
    names = S._dim_names(mesh)
    dp_axes = tuple(a for a in names if a != ax)
    dp_total = 1
    for a in dp_axes:
        dp_total *= S.axis_size(a)

    b, t, d = x.shape
    _, cap_rank, cap_exp = ep_capacities(cfg, b, t, dp_total, tp,
                                         flags.MOE_CAPACITY)
    batch_spec = dp_axes if b % dp_total == 0 else None
    seq_spec = ax if t % tp == 0 else None
    xl = S.redistribute(x, S.placements(P(batch_spec, seq_spec, None), mesh))
    specs = L.specs_moe(cfg, tp)
    pl = L._use_tree({k2: p[k2] for k2 in ("w_gate", "w_up", "w_down")},
                     specs)
    pl["router"] = L._use(p["router"], specs["router"], keep_tp=False)
    loc = xl.to_local()
    bl, tl, _ = loc.shape
    out = _ep_local(pl, loc.reshape(bl * tl, d), cfg, ax=ax, tp=tp,
                    cap_rank=cap_rank, cap_exp=cap_exp)
    y = S.redistribute(S.wrap(out.reshape(bl, tl, d), xl.placements),
                       x.placements)
    if cfg.n_shared_experts:
        dff = cfg.moe_d_ff or cfg.d_ff
        y = y + L._mlp_mesh(p["shared"], x, "swiglu",
                            cfg.n_shared_experts * dff)
    return y
