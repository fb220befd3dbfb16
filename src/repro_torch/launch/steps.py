"""Step builders: train_step / prefill_step / serve_step.

Port of ``repro/launch/steps.py`` on one card: no shardings (they come with
the multi-chip slice).  The steps run eagerly on whatever device the params
and inputs are on; ``serve_step`` updates the cache in place (the reference
donates it to the jitted step).  ``train_step`` takes gradients with
``loss.backward()`` on the params, set to ``requires_grad_()`` for the
step, where the reference takes ``jax.value_and_grad``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.tree import tree_flatten


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
    (``adamw_update``) and returns them."""
    if compress_cross_pod:
        raise NotImplementedError(
            "compress_cross_pod: the int8 cross-pod all-reduce waits for "
            "the multi-chip slice of the port")

    def grads_of(params, batch):
        if num_microbatches == 1:
            return loss_and_grads(cfg, params, batch)
        n = num_microbatches
        b = batch["labels"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        loss_sum, g_acc = 0.0, None
        for i in range(n):
            mb = {k: v[i * (b // n):(i + 1) * (b // n)]
                  for k, v in batch.items()}
            loss, g = loss_and_grads(cfg, params, mb)
            loss_sum = loss_sum + loss
            g32 = [x.float() for x in g]
            g_acc = g32 if g_acc is None else [a + x for a, x in
                                               zip(g_acc, g32)]
        inv = 1.0 / n
        return loss_sum * inv, [g * inv for g in g_acc]

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
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


def init_state(cfg: ModelConfig, opt_cfg: AdamWConfig, gen: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    params = T.init_params(cfg, gen, device)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


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
    (B, T, D)."""

    def prefill_step(params, batch):
        if "embeds" in batch:
            h, _ = T.hidden_embeds(params, batch["embeds"], cfg)
        else:
            h, _ = T.hidden_embeds(params, T.embed(params, batch["tokens"],
                                                   cfg), cfg)
        logits = T._head(params, cfg, h[:, -1:])
        return logits[:, 0], h

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, tokens (B, 1), cache, cur_len) -> (next token ids
    (B,) int32, cache)."""

    def serve_step(params, tokens, cache, cur_len):
        logits, cache = T.decode_step(params, cfg, tokens, cache, cur_len)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
