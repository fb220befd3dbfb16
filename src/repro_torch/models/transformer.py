"""The model stack: embeddings -> layer loop -> head.

Port of ``repro/models/transformer.py`` for every family: each layer is an
attention mixer (GQA or MLA) or a Mamba2 mixer, then an MLP, a MoE or no
FFN, as the reference's ``layer_descs`` lays them out (DeepSeek's leading
dense layers, Jamba's one attention layer a period and MoE every other
layer).  The reference scans a stacked layer tree (``stage_plan``) so that
its compiled program stays O(1) in depth; PyTorch runs eagerly, so the
port keeps one params dict per layer under ``params["layers"]`` and loops
over them.  ``params_from_reference`` unstacks the reference's tree into
that layout.  Activation checkpointing (``flags.REMAT``) wraps what the
reference's ``_maybe_remat`` wraps: each period block of ``stage_plan``,
never the prefix layers, and only without a cache and with autograd on.
DeepSeek's multi-token prediction (``cfg.mtp_depth``) draws
``params["mtp"]`` and adds its two-ahead term to the loss on tokens.

Entry points:
  init_params            -- parameters drawn on the card (or ``device``)
  forward / forward_embeds / hidden_embeds -- full-sequence logits / hidden
  init_cache / decode_step -- the per-layer caches (KV, MLA latent, Mamba2
                            state) and one token step with them
  loss_fn                -- next-token cross-entropy, the training objective
  params_from_reference  -- the JAX tree (as numpy) as the port's params
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str   # attn | ssm
    ffn: str    # mlp | moe | none


# the MTP head's one block, whatever the stack's layers are
MTP_DESC = LayerDesc("attn", "mlp")


def layer_descs(cfg: ModelConfig) -> List[LayerDesc]:
    kinds = cfg.layer_kinds()
    out = []
    for i in range(cfg.n_layers):
        if cfg.layer_has_moe(i):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "mlp"
        else:
            ffn = "none"
        out.append(LayerDesc(kinds[i], ffn))
    return out


def stage_plan(cfg: ModelConfig) -> Tuple[List[LayerDesc], List[LayerDesc], int]:
    """(prefix descs, period descs, n_blocks): layers = prefix + period*n.
    The reference's layout of its params tree; the port reads it to unstack
    the tree (``params_from_reference``) and to checkpoint a period block
    at a time (``flags.REMAT``)."""
    descs = layer_descs(cfg)
    npre = cfg.first_dense_layers
    rest = descs[npre:]
    if not rest:
        return descs, [], 0
    for p in range(1, len(rest) + 1):
        if len(rest) % p == 0 and rest == rest[:p] * (len(rest) // p):
            return descs[:npre], rest[:p], len(rest) // p
    return descs[:npre], rest, 1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, desc: LayerDesc,
                dtype, device) -> Params:
    p: Params = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if desc.kind == "attn":
        p["mixer"] = (L.init_mla(gen, cfg, dtype, device) if cfg.use_mla
                      else L.init_attention(gen, cfg, dtype, device))
    else:
        p["mixer"] = L.init_mamba2(gen, cfg, dtype, device)
    if desc.ffn != "none":
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["ffn"] = (L.init_moe(gen, cfg, dtype, device) if desc.ffn == "moe"
                    else L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                    dtype, device))
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> Params:
    """Parameters from the reference's distributions (embed: truncated
    normal x 0.02; projections and experts: truncated normal x d_in**-0.5;
    Mamba2's conv: x 0.1; norms 1; biases 0; the router and Mamba2's
    ``a_log``, ``d_skip``, ``dt_bias`` in f32), drawn from ``gen`` on
    ``device`` in f32 and cast to the config's dtype one matrix (one
    expert) at a time."""
    dev = resolve_device(device)
    descs = layer_descs(cfg)
    dtype = _dtype(cfg)
    params: Params = {
        "embed": (L.truncated_normal((cfg.vocab, cfg.d_model), gen, dev)
                  * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype,
                                         dev)
    params["layers"] = [_init_layer(gen, cfg, d, dtype, dev) for d in descs]
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype,
                                 dev),
            "block": _init_layer(gen, cfg, MTP_DESC, dtype, dev),
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        }
    return params


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: ModelConfig, desc: LayerDesc, p: Params,
               x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Params], cur_len,
               index: Optional[int]) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.kind == "attn" and cfg.use_mla:
        mix, _ = L.mla_fwd(p["mixer"], h, positions, cfg, cache=cache,
                           cur_len=cur_len, layer=index)
    elif desc.kind == "attn":
        mix, _ = L.attention_fwd(p["mixer"], h, positions, cfg, cache=cache,
                                 cur_len=cur_len)
    else:
        mix, _ = L.mamba2_fwd(p["mixer"], h, cfg, state=cache)
    x = x + mix
    if desc.ffn != "none":
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + (L.moe_fwd(p["ffn"], h2, cfg) if desc.ffn == "moe"
                 else L.mlp_fwd(p["ffn"], h2, cfg.mlp_act))
    return x


def _layer_cache(cfg: ModelConfig, desc: LayerDesc, batch: int,
                 max_len: int, dtype, device) -> Params:
    if desc.kind == "attn":
        if cfg.use_mla:
            return L.init_mla_cache(cfg, batch, max_len, dtype, device)
        return L.init_attention_cache(cfg, batch, max_len, dtype, device)
    return L.init_mamba2_state(cfg, batch, dtype, device)


def hidden_embeds(params: Params, embeds: torch.Tensor, cfg: ModelConfig, *,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[Params] = None,
                  cur_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """embeds: (B, T, D) -> (final hidden states (B, T, D), cache).  With a
    cache, every attention layer writes its K and V (or MLA latent) at
    ``cur_len`` in place and every Mamba2 layer steps its state in place."""
    b, t, _ = embeds.shape
    if positions is None:
        if cur_len is not None:
            positions = torch.full((b, t), int(cur_len), dtype=torch.int32,
                                   device=embeds.device)
        else:
            positions = torch.arange(t, dtype=torch.int32,
                                     device=embeds.device).expand(b, t)
    descs = layer_descs(cfg)
    layers = params["layers"]
    assert len(layers) == len(descs), (len(layers), len(descs))

    def run(x, lo, hi):
        for i in range(lo, hi):
            c = cache["layers"][i] if cache is not None else None
            x = _layer_fwd(cfg, descs[i], layers[i], x, positions, c,
                           cur_len, i)
        return x

    prefix, period, nblocks = stage_plan(cfg)
    x = run(embeds, 0, len(prefix))
    remat = (flags.REMAT != "none" and cache is None
             and torch.is_grad_enabled())
    for j in range(nblocks):
        lo = len(prefix) + j * len(period)
        x = (_remat(run, x, lo, lo + len(period)) if remat
             else run(x, lo, lo + len(period)))
    return x, cache


# The un-batched products (the projections): what the reference's
# ``checkpoint_dots_with_no_batch_dims`` keeps.  A dense linear layer's
# (B, T, in) x (in, out) folds into one of these; the MoE experts'
# batched products, the attention (the flash forward included) and every
# elementwise op are recomputed.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, *args):
    """``fn(*args)`` under ``flags.REMAT``: ``full`` keeps only the block's
    input and recomputes the block in the backward; ``dots`` also keeps
    the outputs of its un-batched products (``_DOTS``)."""
    if flags.REMAT == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    return ckpt.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy))


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.apply_linear(head, x)


def forward_embeds(params: Params, embeds: torch.Tensor, cfg: ModelConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[Params] = None,
                   cur_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """embeds: (B, T, D) -> (logits (B, T, V), cache)."""
    x, cache = hidden_embeds(params, embeds, cfg, positions=positions,
                             cache=cache, cur_len=cur_len)
    return _head(params, cfg, x), cache


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(_dtype(cfg))


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[Params] = None,
            cur_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """tokens: (B, T) int -> (logits (B, T, V), cache)."""
    return forward_embeds(params, embed(params, tokens, cfg), cfg,
                          cache=cache, cur_len=cur_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Params:
    dev = resolve_device(device)
    return {"layers": [_layer_cache(cfg, d, batch, max_len, _dtype(cfg), dev)
                       for d in layer_descs(cfg)]}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, cur_len: int) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); cur_len: the shared write position.
    Returns the last position's logits (B, V) and the cache, updated in
    place."""
    logits, cache = forward(params, tokens, cfg, cache=cache, cur_len=cur_len)
    return logits[:, -1], cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def loss_fn(params: Params, tokens: Optional[torch.Tensor],
            labels: torch.Tensor, cfg: ModelConfig, *,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy on f32 logits; tokens (B, T) or embeds
    (B, T, D), labels (B, T) -> the mean over every position.  On tokens,
    a model with ``cfg.mtp_depth`` adds 0.3 x the cross-entropy of its MTP
    head, which predicts labels[t + 1] from (h_t, embed(labels_t)): the
    final hidden states normed and concatenated with the labels'
    embeddings, projected to d_model, one attention + MLP block, the output
    head (no final norm), against the labels shifted by one with the last
    repeated (the reference's ``loss_fn``)."""
    use_mtp = embeds is None and bool(cfg.mtp_depth)
    if embeds is None:
        embeds = embed(params, tokens, cfg)
    h, _ = hidden_embeds(params, embeds, cfg)
    loss = _xent(_head(params, cfg, h), labels)
    if use_mtp:
        mtp = params["mtp"]
        z = torch.cat([L.rms_norm(h, mtp["norm"], cfg.norm_eps),
                       embed(params, labels, cfg)], dim=-1)
        z = L.apply_linear(mtp["proj"], z)
        b, t, _ = z.shape
        pos = torch.arange(t, dtype=torch.int32, device=z.device).expand(b, t)
        z = _layer_fwd(cfg, MTP_DESC, mtp["block"], z, pos, None, None, None)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        loss = loss + 0.3 * _xent(L.apply_linear(head, z), mtp_labels)
    return loss


# ---------------------------------------------------------------------------
# the reference's params, carried over
# ---------------------------------------------------------------------------

def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (bf16 from ``ml_dtypes`` included) as a tensor.
    ``torch.from_numpy`` refuses ml_dtypes' bfloat16, so it crosses as its
    uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _is_bcsr(leaf) -> bool:
    return all(hasattr(leaf, n) for n in ("blocks", "blockcol", "nblocks",
                                          "block"))


def _convert(tree, device, dtype, index: Optional[int] = None):
    """The reference's subtree as the port's: arrays become tensors and
    BCSR leaves ``BcsrMatrix``es with tiles in the model's dtype; with
    ``index``, the stacked leading axis is sliced first."""
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, index) for k, v in tree.items()}
    if _is_bcsr(tree):
        pick = (lambda a: np.asarray(a)[index]) if index is not None else (
            lambda a: np.asarray(a))
        return BcsrMatrix(blocks=_tensor(pick(tree.blocks), device, dtype),
                          blockcol=_tensor(pick(tree.blockcol), device,
                                           torch.int32),
                          nblocks=_tensor(pick(tree.nblocks), device,
                                          torch.int32),
                          shape=tuple(tree.shape), block=tuple(tree.block))
    a = np.asarray(tree)
    return _tensor(a[index] if index is not None else a, device)


def params_from_reference(np_params: Params, cfg: ModelConfig,
                          device="cuda") -> Params:
    """The reference's ``init_params`` tree (leaves as numpy arrays, bf16
    ones included; ``BcsrMatrix`` leaves from its ``sparsify_params``,
    stacked over the scanned layers) as the port's params.

    Stacked leaves are sliced per layer (a MoE layer's (L, E, in, out)
    experts to its (E, in, out) bank).  Arrays keep their dtype (the f32
    router and Mamba2 leaves of a bf16 model stay f32); the MTP head
    (``mtp``, unstacked) is carried as it is.  A stacked BCSR leaf keeps the
    stack's tile count KB (rows padded to the deepest layer's); its padding
    tiles are inert and the kernel stops at ``nblocks``.  BCSR tiles are
    cast to the model's dtype: the reference prunes in f32 and keeps f32
    tiles, whose values came from the model's dtype, so the cast is exact,
    and the kernel takes tiles of its input's dtype.
    """
    dev = resolve_device(device)
    descs = layer_descs(cfg)
    dtype = _dtype(cfg)
    prefix, period, nblocks = stage_plan(cfg)
    layers = [_convert(p, dev, dtype) for p in np_params["prefix"]]
    for bi in range(nblocks):
        for j in range(len(period)):
            layers.append(_convert(np_params["stack"][f"sub{j}"], dev, dtype,
                                   index=bi))
    assert len(layers) == len(descs), (len(layers), len(descs))
    out: Params = {k: _convert(np_params[k], dev, dtype)
                   for k in ("embed", "final_norm", "lm_head")
                   if k in np_params}
    out["layers"] = layers
    if "mtp" in np_params:
        out["mtp"] = _convert(np_params["mtp"], dev, dtype)
    return out
