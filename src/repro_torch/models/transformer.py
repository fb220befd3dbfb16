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

A mesh run (``distributed.sharding.use_rules``) gives the entry points
DTensor inputs (``tokens`` / ``embeds`` / ``labels`` with the batch over
"dp") and params holding each rank's shards (``param_specs``); the layers
run on local shards and the residual stream is a DTensor that the
reference's four ``constrain`` sites place (batch over "dp", sequence over
"sp"; the logits' vocabulary over "tp").  ``loss_fn`` then returns this
rank's part of the loss (the parts sum to it).  Outside a mesh run the
sites are no-ops.  ``decode_step`` runs there too, on DTensor tokens
(B, 1), a cache placed by ``cache_specs`` (``steps.place_cache``) and a
host-int ``cur_len``: at T 1 the sites leave the stream whole over "sp"
(``sharding.placements`` leaves a dim whole that its mesh dims do not
divide), and the logits come back a DTensor, vocabulary over "tp".

Entry points:
  init_params / param_specs -- parameters drawn on the card (or ``device``)
                            and their logical partition specs
  forward / forward_embeds / hidden_embeds -- full-sequence logits / hidden
  init_cache / cache_specs / decode_step -- the per-layer caches (KV, MLA
                            latent, Mamba2 state), their specs, and one
                            token step with them
  loss_fn                -- next-token cross-entropy, the training objective
  params_from_reference  -- the JAX tree (as numpy) as the port's params
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.core.sparse_format import BcsrMatrix
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P, constrain
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_flatten, tree_map

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
# logical partition specs of the params and caches (the reference's, in the
# port's layout: one entry per layer, no stacked leading dim)
# ---------------------------------------------------------------------------

def _layer_specs(cfg: ModelConfig, desc: LayerDesc, tp: int) -> Params:
    p: Params = {"ln1": P(None)}
    if desc.kind == "attn":
        p["mixer"] = (L.specs_mla(cfg, tp) if cfg.use_mla
                      else L.specs_attention(cfg, tp))
    else:
        p["mixer"] = L.specs_mamba2(cfg, tp)
    if desc.ffn != "none":
        p["ln2"] = P(None)
        p["ffn"] = (L.specs_moe(cfg, tp) if desc.ffn == "moe"
                    else L.specs_mlp(cfg.d_ff, cfg.mlp_act, tp))
    return p


def param_specs(cfg: ModelConfig, tp: int) -> Params:
    """The tree of ``init_params`` with a logical spec (``P``) a leaf."""
    vshard = "tp" if cfg.vocab % max(tp, 1) == 0 else None
    specs: Params = {"embed": P(vshard, "fsdp"), "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P("fsdp", vshard)
    specs["layers"] = [_layer_specs(cfg, d, tp) for d in layer_descs(cfg)]
    if cfg.mtp_depth:
        specs["mtp"] = {"proj": P("fsdp", None),
                        "block": _layer_specs(cfg, MTP_DESC, tp),
                        "norm": P(None)}
    return specs


def _layer_cache_specs(cfg: ModelConfig, desc: LayerDesc, tp: int) -> Params:
    if desc.kind == "attn":
        if cfg.use_mla:
            return L.specs_mla_cache(cfg, tp)
        return L.specs_attention_cache(cfg, tp)
    return L.specs_mamba2_state(cfg, tp)


def cache_specs(cfg: ModelConfig, tp: int) -> Params:
    """The tree of ``init_cache`` with a logical spec a leaf."""
    return {"layers": [_layer_cache_specs(cfg, d, tp)
                       for d in layer_descs(cfg)]}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def local_shards(params: Params) -> Params:
    """``params`` with each DTensor leaf as this rank's local tensor (no
    copy): what the meshed blocks read."""
    if not any(isinstance(x, DTensor) for x in tree_flatten(params)[0]):
        return params
    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    params)


def _norm(x, scale: torch.Tensor, eps: float):
    if isinstance(x, DTensor):
        return S.map_local(L.rms_norm, x, scale, eps)
    return L.rms_norm(x, scale, eps)


def _layer_fwd(cfg: ModelConfig, desc: LayerDesc, p: Params,
               x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Params], cur_len,
               index: Optional[int]) -> torch.Tensor:
    h = _norm(x, p["ln1"], cfg.norm_eps)
    if desc.kind == "attn" and cfg.use_mla:
        mix, _ = L.mla_fwd(p["mixer"], h, positions, cfg, cache=cache,
                           cur_len=cur_len, layer=index)
    elif desc.kind == "attn":
        mix, _ = L.attention_fwd(p["mixer"], h, positions, cfg, cache=cache,
                                 cur_len=cur_len, layer=index)
    else:
        mix, _ = L.mamba2_fwd(p["mixer"], h, cfg, state=cache, layer=index)
    x = x + mix
    x = constrain(x, "dp", "sp", None)
    if desc.ffn != "none":
        h2 = _norm(x, p["ln2"], cfg.norm_eps)
        x = x + (L.moe_fwd(p["ffn"], h2, cfg) if desc.ffn == "moe"
                 else L.mlp_fwd(p["ffn"], h2, cfg.mlp_act, d_ff=cfg.d_ff))
        x = constrain(x, "dp", "sp", None)
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
    ``cur_len`` in place and every Mamba2 layer steps its state in place.
    DTensor ``embeds`` (a mesh run): each block makes its own positions
    (0..T-1, or ``cur_len`` with a placed cache), the result a DTensor."""
    b, t, _ = embeds.shape
    if isinstance(embeds, DTensor):
        params = local_shards(params)
        if positions is not None:
            raise ValueError("hidden_embeds: a mesh run takes positions "
                             "0..T-1, or cur_len with a cache")
    elif positions is None:
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
    x = run(constrain(embeds, "dp", "sp", None), 0, len(prefix))
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


def _vshard(cfg: ModelConfig) -> bool:
    tp = S.tp_size()
    return tp > 1 and cfg.vocab % tp == 0


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) through the output head (no norm).  A DTensor x: the
    sequence gathered, the rank's vocabulary columns of the head (gathered
    over "fsdp"), the logits' vocabulary over "tp"."""
    if not isinstance(x, DTensor):
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return L.apply_linear(head, x)
    vs = "tp" if cfg.vocab % S.tp_size() == 0 else None
    head = (L._use(params["embed"], P(vs, "fsdp")).T if cfg.tie_embeddings
            else L._use(params["lm_head"], P("fsdp", vs)))
    xf = constrain(x, "dp", None, None)
    return S.wrap(L.apply_linear(head, xf.to_local()),
                  L._on_tp(xf, Shard(2) if _vshard(cfg) else Replicate()))


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(_logits(params, cfg, x), "dp", None, "tp")


def forward_embeds(params: Params, embeds: torch.Tensor, cfg: ModelConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[Params] = None,
                   cur_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """embeds: (B, T, D) -> (logits (B, T, V), cache)."""
    if isinstance(embeds, DTensor):
        params = local_shards(params)
    x, cache = hidden_embeds(params, embeds, cfg, positions=positions,
                             cache=cache, cur_len=cur_len)
    return _head(params, cfg, x), cache


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings.  DTensor ``tokens`` (a mesh run): a lookup in the
    rank's vocabulary rows (gathered over "fsdp"), zero for the tokens of
    the others, so the result is partial over "tp" until ``constrain``
    sums it."""
    if not isinstance(tokens, DTensor):
        return params["embed"][tokens.long()].to(_dtype(cfg))
    vs = _vshard(cfg)
    w = L._use(params["embed"], P("tp" if vs else None, "fsdp"))
    tl = tokens.to_local().long()
    if vs:
        v0 = S.axis_index(S.tp_axis()) * w.shape[0]
        inside = (tl >= v0) & (tl < v0 + w.shape[0])
        e = w[torch.where(inside, tl - v0, torch.zeros_like(tl))]
        e = e * inside[..., None].to(e.dtype)
    else:
        e = w[tl]
    return S.wrap(e.to(_dtype(cfg)),
                  L._on_tp(tokens, Partial() if vs else Replicate()))


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[Params] = None,
            cur_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """tokens: (B, T) int -> (logits (B, T, V), cache)."""
    if isinstance(tokens, DTensor):
        params = local_shards(params)
    return forward_embeds(params, embed(params, tokens, cfg), cfg,
                          cache=cache, cur_len=cur_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Params:
    dev = resolve_device(device)
    return {"layers": [_layer_cache(cfg, d, batch, max_len, _dtype(cfg), dev)
                       for d in layer_descs(cfg)]}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, cur_len: int) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); cur_len: the shared write position
    (a host int).  Returns the last position's logits (B, V) and the cache,
    updated in place.  On a mesh (DTensor tokens, placed params and cache):
    the logits a DTensor, batch over "dp" and vocabulary over "tp"."""
    logits, cache = forward(params, tokens, cfg, cache=cache, cur_len=cur_len)
    return last_position(logits), cache


def last_position(x: torch.Tensor) -> torch.Tensor:
    """x (B, T, ...) -> x[:, -1]; of a DTensor whose sequence is whole, its
    local shard's, each sharded dim past the sequence one lower."""
    if not isinstance(x, DTensor):
        return x[:, -1]
    pls = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
           for p in x.placements]
    return S.wrap(x.to_local()[:, -1], pls)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if isinstance(logits, DTensor):
        return _xent_mesh(logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def _xent_mesh(logits: DTensor, labels: DTensor) -> torch.Tensor:
    """This rank's part of the mean cross-entropy: over its batch shard
    and its sequence chunk of the "tp" dim (the part its residual stream
    holds), divided by the global token count.  Vocabulary-sharded logits
    take the max, the sum of exponentials and the gold logit over "tp"
    (the max outside autograd)."""
    ax = S.tp_axis()
    lf = logits.to_local().float()
    lab = labels.to_local().long()
    if S.tp_size() > 1 and isinstance(
            logits.placements[S._dim_names(S.get_mesh()).index(ax)], Shard):
        v = lf.shape[-1]
        v0 = S.axis_index(ax) * v
        m = C.value_max(lf.detach().amax(dim=-1), [ax])
        lse = torch.log(C.all_reduce(
            torch.exp(lf - m[..., None]).sum(dim=-1), ax)) + m
        inside = (lab >= v0) & (lab < v0 + v)
        idx = torch.where(inside, lab - v0, torch.zeros_like(lab))
        gold = torch.gather(lf, -1, idx[..., None])[..., 0] * inside
        gold = C.all_reduce(gold, ax)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    per_tok = lse - gold
    tp = S.tp_size()
    if tp > 1:
        t, r = per_tok.shape[1], S.axis_index(ax)
        per_tok = (per_tok.narrow(1, r * (t // tp), t // tp) if t % tp == 0
                   else per_tok[:, :t * (r == 0)])
    # the mean of a whole batch is the single device's op, bit for bit
    return per_tok.mean() * (per_tok.numel() / labels.numel())


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
    if isinstance(labels, DTensor):
        params = local_shards(params)
    if embeds is None:
        embeds = embed(params, tokens, cfg)
    h, _ = hidden_embeds(params, embeds, cfg)
    loss = _xent(_head(params, cfg, h), labels)
    if use_mtp:
        loss = loss + 0.3 * _mtp_loss(params, h, labels, cfg)
    return loss


def _mtp_loss(params: Params, h, labels, cfg: ModelConfig) -> torch.Tensor:
    mtp = params["mtp"]
    hn = _norm(h, mtp["norm"], cfg.norm_eps)
    nxt = lambda lab: torch.cat([lab[:, 1:], lab[:, -1:]], dim=1)
    if isinstance(h, DTensor):
        e = constrain(embed(params, labels, cfg), "dp", "sp", None)
        proj = L._use(mtp["proj"], P("fsdp", None))
        z = S.map_local(lambda a, b: L.apply_linear(
            proj, torch.cat([a, b], dim=-1)), hn, e.to_local())
        pos, mtp_labels = None, S.map_local(nxt, labels)
    else:
        z = L.apply_linear(mtp["proj"],
                           torch.cat([hn, embed(params, labels, cfg)], dim=-1))
        b, t, _ = z.shape
        pos = torch.arange(t, dtype=torch.int32, device=z.device).expand(b, t)
        mtp_labels = nxt(labels)
    z = _layer_fwd(cfg, MTP_DESC, mtp["block"], z, pos, None, None, None)
    return _xent(_logits(params, cfg, z), mtp_labels)


# ---------------------------------------------------------------------------
# the reference's params, carried over
# ---------------------------------------------------------------------------

def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (bf16 from ``ml_dtypes`` included), or a tensor, as a
    tensor on ``device``.  ``torch.from_numpy`` refuses ml_dtypes'
    bfloat16, so it crosses as its uint16 bits."""
    if torch.is_tensor(a):
        t = a.to(device)
        return t if dtype is None else t.to(dtype)
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
        pick = (lambda a: _array(a)[index]) if index is not None else _array
        return BcsrMatrix(blocks=_tensor(pick(tree.blocks), device, dtype),
                          blockcol=_tensor(pick(tree.blockcol), device,
                                           torch.int32),
                          nblocks=_tensor(pick(tree.nblocks), device,
                                          torch.int32),
                          shape=tuple(tree.shape), block=tuple(tree.block))
    a = _array(tree)
    return _tensor(a[index] if index is not None else a, device)


def _array(a):
    """A leaf as an indexable array: tensors (a checkpoint's, bf16
    included) as they are, anything else through numpy."""
    return a if torch.is_tensor(a) else np.asarray(a)


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
    # (a checkpoint read back by path holds no empty prefix)
    layers = [_convert(p, dev, dtype) for p in np_params.get("prefix", [])]
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
