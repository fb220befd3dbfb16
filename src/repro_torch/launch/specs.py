"""Input stand-ins and their logical specs for every (arch x shape) cell.

Port of ``repro/launch/specs.py``: tensors on the ``meta`` device (shapes
and dtypes, no storage) where the reference has ``ShapeDtypeStruct``s,
beside logical partition specs (``P``) that ``sharding.placements``
resolves on a mesh.  [audio]/[vlm] archs take precomputed frame/patch
embeddings (the frontend is a stub).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.tree import tree_map

STUB_EMBED_FAMILIES = ("vlm", "encoder")   # the modality frontend is a stub


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the ``meta`` device."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(stand-ins, logical specs) for one train batch."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.family in STUB_EMBED_FAMILIES:
        specs = {"embeds": sds((b, t, cfg.d_model), cfg.dtype),
                 "labels": sds((b, t), torch.int32)}
        parts = {"embeds": P("dp", "sp", None), "labels": P("dp", "sp")}
    else:
        specs = {"tokens": sds((b, t), torch.int32),
                 "labels": sds((b, t), torch.int32)}
        parts = {"tokens": P("dp", "sp"), "labels": P("dp", "sp")}
    return specs, parts


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    b, t = shape.global_batch, shape.seq_len
    if cfg.family in STUB_EMBED_FAMILIES:
        return ({"embeds": sds((b, t, cfg.d_model), cfg.dtype)},
                {"embeds": P("dp", "sp", None)})
    return ({"tokens": sds((b, t), torch.int32)}, {"tokens": P("dp", "sp")})


def _drop_batch_axis(parts):
    """Replace the 'dp' entries with None on every spec (a batch the dp
    extent does not divide, e.g. long_500k's global_batch=1: placed inputs
    must split evenly, unlike constrained activations)."""
    return tree_map(lambda spec: P(*(None if e == "dp" else e for e in spec)),
                    parts)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                       dp: int = 1) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """tokens (B, 1) + the full KV/SSM cache of seq_len + cur_len scalar."""
    b, s = shape.global_batch, shape.seq_len
    cache = T.init_cache(cfg, b, s, device="meta")
    specs = {"tokens": sds((b, 1), torch.int32), "cache": cache,
             "cur_len": sds((), torch.int32)}
    parts = {"tokens": P("dp", None), "cache": T.cache_specs(cfg, tp),
             "cur_len": P(), "next_tokens": P("dp")}
    if dp and b % dp:
        parts = _drop_batch_axis(parts)
    return specs, parts


def input_specs(cfg: ModelConfig, shape: ShapeConfig, tp: int, dp: int = 1
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape, tp, dp)
