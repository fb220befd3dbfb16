"""The steps a server runs: prefill_step / serve_step.

Port of the serving half of ``repro/launch/steps.py``; ``make_train_step``
and the shardings come with the training slice.  The steps run eagerly on
whatever device the params and inputs are on; ``serve_step`` updates the
cache in place (the reference donates it to the jitted step).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


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
