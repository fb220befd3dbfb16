"""AdamW with optional bf16 moment state.

Port of ``repro/optim/adamw.py`` over the port's params trees (nested dicts
and lists of tensors), every update in f32 whatever the params' and the
state's dtypes, as the reference computes it.  ``adamw_update`` writes the
update into the given params and moments (what the reference's launchers
get by donating the state to the jitted step): the old and the new state
never stand side by side, and a leaf is updated a slice of at most
``UPDATE_SLICE`` elements at a time, so its f32 temporaries stay small
whatever its size.  A model whose state fills most of the card still takes
a step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # "bfloat16" halves the moments' memory


def adamw_init(params: Any, cfg: AdamWConfig) -> Any:
    dt = getattr(torch, cfg.state_dtype)
    leaves, _ = tree_flatten(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def _global_norm(grads: Any) -> torch.Tensor:
    leaves, _ = tree_flatten(grads)
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


# elements of a leaf updated at a time (whole rows of its first dim): the
# f32 temporaries of a slice are a few times 64 MiB
UPDATE_SLICE = 1 << 24


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / ||grads||), ||grads||), each leaf
    scaled in f32 and cast back to its dtype."""
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _slices(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, ...]:
    """Views of ``x`` that cover it in order, each of whole rows of its
    first dim and at most ``n`` elements where a row allows (a 0-d ``x``
    as one)."""
    if x.dim() == 0:
        return (x.view(1),)
    row = x[0].numel() if x.shape[0] else 1
    return x.split(max(1, n // max(1, row)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt_state: Any, cfg: AdamWConfig,
                 lr, *, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Any, torch.Tensor]:
    """One step, written into ``params`` and ``opt_state``'s moments slice
    by slice; returns (params, the opt state with the new step counter,
    grad_norm).  The values are the reference's: the gradients clipped
    (scaled in f32 and cast back to their dtype), then the update in f32,
    cast to each leaf's dtype.  ``gnorm``: the global norm, where the trees
    hold one rank's shards (a mesh run)."""
    if gnorm is None:
        gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else 1.0
    step = opt_state["step"] + 1
    sf = step.float()
    bc1 = 1.0 - cfg.b1 ** sf
    bc2 = 1.0 - cfg.b2 ** sf
    flat = [tree_flatten(t)[0] for t in (params, grads, opt_state["m"],
                                          opt_state["v"])]
    # the last op of each value writes into its leaf (cast on the store, as
    # ``.to`` rounds); bf16 moments keep their f32 value for the update
    f32 = lambda x: x if x.dtype == torch.float32 else None
    for leaf in zip(*flat):
        for p, g, m, v in zip(*(_slices(x, UPDATE_SLICE) for x in leaf)):
            gf = (g.float() * scale).to(g.dtype).float()
            m32 = torch.add(cfg.b1 * m.float(), (1 - cfg.b1) * gf, out=f32(m))
            v32 = torch.add(cfg.b2 * v.float(),
                            (1 - cfg.b2) * torch.square(gf), out=f32(v))
            mh = m32 / bc1
            vh = v32 / bc2
            delta = (mh / (torch.sqrt(vh) + cfg.eps)
                     + cfg.weight_decay * p.float())
            torch.sub(p.float(), lr * delta, out=p)
            m.copy_(m32)  # (nothing to do where m32 is m: f32 moments)
            v.copy_(v32)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gnorm
