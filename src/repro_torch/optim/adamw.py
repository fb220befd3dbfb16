"""AdamW with optional bf16 moment state.

Port of ``repro/optim/adamw.py``: pure functions over the port's params
trees (nested dicts and lists of tensors), every update in f32 whatever the
params' and the state's dtypes, as the reference computes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

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


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / ||grads||), ||grads||), each leaf
    scaled in f32 and cast back to its dtype."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, opt_state: Any, cfg: AdamWConfig,
                 lr) -> Tuple[Any, Any, torch.Tensor]:
    """Returns (new_params, new_opt_state, grad_norm)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = _global_norm(grads)
    step = opt_state["step"] + 1
    sf = step.float()
    bc1 = 1.0 - cfg.b1 ** sf
    bc2 = 1.0 - cfg.b2 ** sf
    dt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        gf = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(gf)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m32.to(dt), v32.to(dt))

    flat_p, rebuild = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(opt_state["m"])
    flat_v, _ = tree_flatten(opt_state["v"])
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                  flat_v)]
    new_p = rebuild([o[0] for o in out])
    new_m = rebuild([o[1] for o in out])
    new_v = rebuild([o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
