"""Model building blocks of every architecture the port runs.

Port of ``repro/models/layers.py``: linear application over dense, BCSR
and ELL weights, RMSNorm, RoPE, the full-sequence attention (the flash
kernel or the chunked online softmax), decode attention over a KV cache,
the GQA attention block, DeepSeek's multi-head latent attention (MLA), the
MLP, the routed mixture of experts (MoE) with its shared experts, and the
Mamba2 block (the chunked SSD scan and its one-step recurrence).  Every
``init_*`` has a mirror ``specs_*``: logical partition specs ("fsdp", "tp")
that ``distributed/sharding.py`` resolves on a mesh.

In a mesh run (``sharding.use_rules``) the blocks take a DTensor activation
and run on local shards (the mesh paths at the end of this file): the
attention on its rank's heads (the reference's tensor-parallel flash modes
A and B), the MLP on its d_ff columns, the MoE on its experts (or
expert-parallel, ``moe_ep.py``), each returning its output in the
activation's placements.  Decode runs there too, on a cache placed by
``transformer.cache_specs`` (``steps.place_cache``): a GQA cache with its
KV heads over "tp" (each rank attends on its heads) or its sequence over
"tp" (each rank attends over its slice, the slices combined by
log-sum-exp), the MLA latent cache by sequence the same way, and the
Mamba2 state with its heads over "tp".

Conventions, as in the reference: params are nested dicts of tensors;
dense linear weights are (in_features, out_features), so application is
``x @ w``; ``BcsrMatrix`` / ``EllMatrix`` leaves have the logical shape
(out, in) and go through the Escoin sparse path.  Weights are drawn with a
``torch.Generator`` from the reference's distributions; the values differ
from ``jax.random``'s, so a comparison carries the reference's params over
(``transformer.params_from_reference``).  Caches and recurrent states are
updated in place (the reference returns new ones from its jitted step).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.sparse_format import BcsrMatrix, EllMatrix
from repro_torch.core.sparse_linear import ell_matmul
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P
from repro_torch.kernels.bsr_matmul.ops import bsr_matmul
from repro_torch.kernels.flash_attention.ops import flash_attention_bthd
from repro_torch.models import flags
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def truncated_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], f32, as
    ``jax.random.truncated_normal(key, -2, 2, shape)`` draws it."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    return (truncated_normal((d_in, d_out), gen, device) * scale).to(dtype)


def apply_linear(w, x: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear application dispatching on the weight's storage format.

    Dense (in, out) tensor -> ``x @ w`` with f32 accumulate in the
    promoted dtype of x and w, cast to x's dtype (cuBLAS on the card, as the
    reference leaves it to XLA): the reference's einsum promotes an f32 x
    over a bf16 weight (f32 embeddings on a bf16 model) to an f32 product,
    so the activations stay f32.  ``BcsrMatrix`` of logical shape (out, in)
    -> the ``bsr_matmul`` kernel (which promotes the same way);
    ``EllMatrix`` -> ``ell_matmul``.
    """
    if isinstance(w, BcsrMatrix):
        y = bsr_matmul(x, w)
    elif isinstance(w, EllMatrix):
        y = ell_matmul(x, w)
    else:  # bf16 products accumulate in f32 in cuBLAS and on the CPU
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (B, T, H, hd), positions: (B, T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None, None] * freqs          # (B, T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# full-sequence attention: the flash kernel (flags.ATTN_IMPL == "flash") or
# the chunked online softmax
# ---------------------------------------------------------------------------

def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, H, hd), k/v (B, S, KV, hdv) -> (B, T, H, hdv).  The flash
    kernel needs hd == hdv; other shapes take the chunked path, as in the
    reference.  In a mesh run q, k and v hold one rank's heads
    (``_attention_mesh``)."""
    if flags.ATTN_IMPL != "flash" or q.shape[-1] != v.shape[-1]:
        return chunked_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_bthd(q, k, v, causal=causal, scale=scale)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk_q: Optional[int] = None,
                      chunk_k: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, T, H, hd), k/v: (B, S, KV, hd[v]) -> (B, T, H, hdv).

    Online softmax over kv chunks inside a loop over q chunks, as the
    reference's double scan; the live buffer is (B, KV, G, cq, ck).
    """
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    cq = min(chunk_q or flags.ATTN_CHUNK, t)
    ck = min(chunk_k or flags.ATTN_CHUNK, s)
    assert t % cq == 0 and s % ck == 0, (t, s, cq, ck)

    qf = q.reshape(b, t, kv, g, hd).float() * scale
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, t, cq):
        qblk = qf[:, q0:q0 + cq]                             # (B, cq, KV, G, hd)
        m = torch.full((b, kv, g, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, kv, g, cq), device=q.device)
        acc = torch.zeros((b, kv, g, cq, hdv), device=q.device)
        for k0 in range(0, s, ck):
            logits = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                                  kf[:, k0:k0 + ck])         # (B,KV,G,cq,ck)
            if causal:
                qpos = q0 + torch.arange(cq, device=q.device)
                kpos = k0 + torch.arange(ck, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                logits = torch.where(mask, logits,
                                     torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vf[:, k0:k0 + ck])
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,KV,G,cq,hdv)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (B,cq,KV,G,hdv)
    out = torch.cat(outs, dim=1).reshape(b, t, h, hdv)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention over a KV cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); cur_len: the number of valid
    cache positions.
    """
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = scale if scale is not None else hd ** -0.5
    qf = q.reshape(b, kv, g, hd).float() * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    mask = torch.arange(s, device=q.device) < cur_len
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> Params:
    hd = cfg.head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def write_cache(cache: torch.Tensor, new: torch.Tensor, cur_len: int) -> None:
    """Write ``new`` (B, t, ...) into ``cache`` (B, S, ...) at position
    ``cur_len`` of every row, in place.  The start is clamped to S - t, as
    ``lax.dynamic_update_slice`` clamps it."""
    t = new.shape[1]
    start = max(0, min(int(cur_len), cache.shape[1] - t))
    cache[:, start:start + t] = new


def attention_fwd(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, cache: Optional[Params] = None,
                  cur_len: Optional[int] = None, layer: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention.  Without a cache: full-sequence attention.  With one:
    K and V of the new position are written into the cache in place, at the
    shared position ``cur_len`` of every row, and the block attends over
    ``cur_len + 1`` positions; the cache is returned.  A DTensor ``x`` (a
    mesh run) takes ``_attention_mesh``, or with a placed cache
    ``_attention_decode_mesh`` (``layer`` names the layer in its
    errors)."""
    if isinstance(x, DTensor):
        if cache is not None:
            return (_attention_decode_mesh(p, x, cfg, cache, cur_len, layer),
                    cache)
        return _attention_mesh(p, x, cfg), None
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = apply_linear(p["wq"], x, p.get("bq")).reshape(b, t, cfg.n_heads, hd)
    k = apply_linear(p["wk"], x, p.get("bk")).reshape(b, t, cfg.n_kv_heads, hd)
    v = apply_linear(p["wv"], x, p.get("bv")).reshape(b, t, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = full_attention(q, k, v, causal=cfg.causal)
    else:
        write_cache(cache["k"], k, cur_len)
        write_cache(cache["v"], v, cur_len)
        out = decode_attention(q, cache["k"], cache["v"], cur_len + 1)
    out = out.reshape(b, t, cfg.n_heads * hd)
    return apply_linear(p["wo"], out), cache


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                         device) -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
             device) -> Params:
    p = {"up": dense_init(gen, d_model, d_ff, dtype, device),
         "down": dense_init(gen, d_ff, d_model, dtype, device)}
    if act == "swiglu":
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def mlp_fwd(p: Params, x: torch.Tensor, act: str, *,
            d_ff: Optional[int] = None) -> torch.Tensor:
    """A DTensor ``x`` (a mesh run) takes ``_mlp_mesh``, which needs the
    global ``d_ff`` to resolve the weights' specs."""
    if isinstance(x, DTensor):
        return _mlp_mesh(p, x, act, d_ff)
    up = apply_linear(p["up"], x)
    if act == "swiglu":
        h = F.silu(apply_linear(p["gate"], x)) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return apply_linear(p["down"], h)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    qk_hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    h = cfg.n_heads
    p: Params = {}
    if cfg.q_lora_rank:
        p["q_a"] = dense_init(gen, cfg.d_model, cfg.q_lora_rank, dtype, device)
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=dtype,
                                 device=device)
        p["q_b"] = dense_init(gen, cfg.q_lora_rank, h * qk_hd, dtype, device)
    else:
        p["q_b"] = dense_init(gen, cfg.d_model, h * qk_hd, dtype, device)
    p["kv_a"] = dense_init(gen, cfg.d_model,
                           cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype,
                           device)
    p["kv_norm"] = torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=device)
    p["k_b"] = dense_init(gen, cfg.kv_lora_rank, h * cfg.qk_nope_head_dim,
                          dtype, device)
    p["v_b"] = dense_init(gen, cfg.kv_lora_rank, h * cfg.v_head_dim, dtype,
                          device)
    p["wo"] = dense_init(gen, h * cfg.v_head_dim, cfg.d_model, dtype, device)
    return p


def mla_fwd(p: Params, x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, *, cache: Optional[Params] = None,
            cur_len: Optional[int] = None, layer: Optional[int] = None,
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head latent attention.  Without a cache (prefill): per-head K
    and V expanded from the latent, full-sequence attention (hd != hdv, so
    the chunked path, as in the reference).  With one (decode): the
    *absorbed* form, attending in the latent space over the (B, S,
    kv_lora_rank) and (B, S, rope) caches, which are written at
    ``cur_len`` in place.  The absorbed form reads ``k_b`` and ``v_b`` as
    dense (kv_lora_rank, heads, dim) banks; on sparse ones it raises
    (``layer`` names the layer in the message).  A DTensor ``x`` (a mesh
    run) without a cache runs replicated over the ``tp`` dim
    (``_replicated_mesh``), with a placed one ``_mla_decode_mesh``."""
    if isinstance(x, DTensor):
        if cache is not None:
            return _mla_decode_mesh(p, x, cfg, cache, cur_len, layer), cache
        return _replicated_mesh(
            lambda pf, xl: mla_fwd(pf, xl, _positions(xl), cfg)[0],
            p, specs_mla(cfg, S.tp_size()), x), None
    if cache is not None:
        _dense_kv_b(p, cfg, layer)
        out = _mla_absorbed(p, x, positions, cfg, cache, cur_len)
        return apply_linear(p["wo"], out), cache
    b, t, _ = x.shape
    h = cfg.n_heads
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, x, positions, cfg, h)
    k_nope = apply_linear(p["k_b"], c_kv).reshape(b, t, h, nope)
    v = apply_linear(p["v_b"], c_kv).reshape(b, t, h, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, rd)],
                  dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = full_attention(q_full, k, v, causal=cfg.causal,
                         scale=(nope + rd) ** -0.5)
    return apply_linear(p["wo"], out.reshape(b, t, h * vd)), None


def _mla_project(w: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, hl: int) -> Tuple[torch.Tensor, ...]:
    """MLA's projections of ``x``: (q_nope, q_rope roped) of ``hl`` heads
    (``w``'s q_b columns), and the latent ``c_kv`` and roped ``k_rope``
    (B, T, rd) of the new positions."""
    b, t, _ = x.shape
    nope, lat = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    if cfg.q_lora_rank:
        q_c = rms_norm(apply_linear(w["q_a"], x), w["q_norm"], cfg.norm_eps)
    else:
        q_c = x
    q = apply_linear(w["q_b"], q_c).reshape(b, t, hl,
                                            nope + cfg.qk_rope_head_dim)
    q_rope = rope(q[..., nope:], positions, cfg.rope_theta)
    kv = apply_linear(w["kv_a"], x)
    c_kv = rms_norm(kv[..., :lat], w["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., lat:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    return q[..., :nope], q_rope, c_kv, k_rope


def _mla_absorbed(w: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, cache: Params, cur_len: int, *,
                  ax: Optional[str] = None, split: bool = False, n: int = 1
                  ) -> torch.Tensor:
    """The absorbed MLA decode on local tensors, up to ``wo``'s input
    (B, T, heads x v_head_dim) in x's dtype.  One device: every head, the
    whole latent cache.  On a mesh (``_mla_decode_mesh``): where ``split``,
    ``w`` holds this rank's heads' q_b / k_b / v_b columns, whose absorbed
    queries are gathered over ``ax`` and whose latent outputs are kept; the
    cache is slice r of ``n`` along the sequence over ``ax`` (n > 1), the
    owner of ``cur_len`` writes it, and the slices' parts combine by
    log-sum-exp (``_lse_combine``)."""
    b, t, _ = x.shape
    hl = cfg.n_heads // (S.axis_size(ax) if split else 1)
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lat = cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope = _mla_project(w, x, positions, cfg, hl)
    q_rope = q_rope.float()
    q_abs = torch.einsum("bthd,lhd->bthl", q_nope.float(),
                         w["k_b"].reshape(lat, hl, nope).float())
    if split:
        q_abs = C.all_gather(q_abs, 2, ax)
        q_rope = C.all_gather(q_rope, 2, ax)
    r = S.axis_index(ax) if n > 1 else 0
    for name, new in (("c_kv", c_kv), ("k_rope", k_rope)):
        if n > 1:
            _write_seq_shard(cache[name], new, cur_len, r, n)
        else:
            write_cache(cache[name], new, cur_len)
    ckv = cache["c_kv"].float()
    logits = (torch.einsum("bthl,bsl->bhts", q_abs, ckv)
              + torch.einsum("bthd,bsd->bhts", q_rope,
                             cache["k_rope"].float())) * (nope + rd) ** -0.5
    m, l, acc = _attend_shard(logits, cur_len + 1 - r * ckv.shape[1],
                              lambda pr: torch.einsum("bhts,bsl->bhtl", pr,
                                                      ckv))
    o_lat = (_lse_combine(m, l, acc, ax) if n > 1
             else acc / l[..., None]).transpose(1, 2)
    if split:
        o_lat = o_lat[:, :, S.axis_index(ax) * hl:(S.axis_index(ax) + 1) * hl]
    out = torch.einsum("bthl,lhd->bthd", o_lat,
                       w["v_b"].reshape(lat, hl, vd).float()).to(x.dtype)
    return out.reshape(b, t, hl * vd)


def _dense_kv_b(p: Params, cfg: ModelConfig, layer: Optional[int]) -> None:
    """The absorbed MLA decode reads ``k_b`` and ``v_b`` as dense banks:
    raise, naming the layer, on sparse ones."""
    for name in ("k_b", "v_b"):
        if isinstance(p[name], (BcsrMatrix, EllMatrix)):
            where = f"layer {layer}" if layer is not None else "MLA"
            raise ValueError(
                f"{cfg.name}: {where}: the absorbed MLA decode reads "
                f"{name} as a dense (kv_lora_rank, heads, dim) bank, and "
                f"this one is {type(p[name]).__name__}; the reference "
                f"cannot decode it either (its decode reshapes the "
                f"bank).  Serve MLA layers with dense k_b and v_b.")


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MoE: routing, then dispatch by sort and two gathers
# ---------------------------------------------------------------------------

def _experts_init(gen: torch.Generator, shape, d_in: int, dtype,
                  device) -> torch.Tensor:
    """A stacked (E, in, out) expert bank from truncated normal x
    d_in**-0.5, drawn one expert at a time in f32 and cast into the bank,
    so the f32 draw never stands beside the whole bank."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = truncated_normal(shape[1:], gen, device) * (1.0 / d_in) ** 0.5
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    e, d = cfg.n_experts, cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": _experts_init(gen, (e, d, dff), d, dtype, device),
        "w_up": _experts_init(gen, (e, d, dff), d, dtype, device),
        "w_down": _experts_init(gen, (e, dff, d), dff, dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.n_shared_experts * dff, "swiglu",
                               dtype, device)
    return p


def moe_capacity(group: int, cfg: ModelConfig, factor: float) -> int:
    """Slots an expert takes in a group of ``group`` tokens, the
    reference's rule: ``group * top_k / n_experts * factor`` truncated, then
    rounded up to a multiple of 8, at least 8."""
    cap = int(group * cfg.top_k / cfg.n_experts * factor)
    return max(8, ((cap + 7) // 8) * 8)


def moe_route(p: Params, xg: torch.Tensor, cfg: ModelConfig, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Routing and dispatch indices of one group, xg (G, D), as the
    reference's ``_moe_group`` builds them: f32 router logits, softmax,
    top-k, the k weights renormalised; the (token, k) assignments sorted
    stably by expert, each expert's run found by ``searchsorted``, and an
    assignment past its expert's ``capacity`` sent to the trash slot
    E * capacity.  Returns (topw (G, K) f32, token_for_slot (E * C + 1,)
    with sentinel G for an empty slot, slot_for_tokk (G * K,), kept
    (G * K,) bool in sorted order).  The trash entry of token_for_slot
    holds the sentinel (the reference scatters every dropped token there;
    no gather reads it)."""
    g, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    logits = torch.matmul(xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)                    # (G, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(-1)                                    # (G*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                               side="left")
    pos = torch.arange(g * k, device=dev) - start[sorted_e]
    kept = pos < capacity
    trash = e * capacity
    slot = torch.where(kept, sorted_e * capacity + pos,
                       torch.full_like(pos, trash))
    tok = order // k
    token_for_slot = torch.full((trash + 1,), g, dtype=torch.int64,
                                device=dev)
    token_for_slot[slot] = tok     # no read-back: the dropped hit the trash
    token_for_slot[trash] = g
    slot_for_tokk = torch.empty((g * k,), dtype=torch.int64, device=dev)
    slot_for_tokk[order] = slot
    return topw, token_for_slot, slot_for_tokk, kept


class _BmmF32(torch.autograd.Function):
    """``a @ b`` of two bf16 operands on the card with f32 sums and an f32
    result (``out_dtype``, which has no derivative of its own).  The
    backward's two products run the same way on bf16 operands: the f32
    gradient rounded to bf16 once, each result rounded once to its
    operand's dtype, so that a train step keeps the experts' products on
    the tensor cores and makes no f32 copy of their weights."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.transpose(1, 2),
                           out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.transpose(1, 2), g,
                           out_dtype=torch.float32).to(b.dtype)
        return da, db


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with f32 sums and an f32 result, the reference's
    ``preferred_element_type=f32``: on the card a bf16 product returns its
    f32 sums unrounded, forward and backward on bf16 operands
    (``_BmmF32``); on the CPU the operands are multiplied in f32, which
    holds the same products exactly; an f32 ``a`` (f32 activations) takes
    ``b`` in f32, as the reference's einsum promotes it."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b.float())
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def experts_fwd(p: Params, xe: torch.Tensor, dtype) -> torch.Tensor:
    """The experts' SwiGLU on their dispatch buffers xe (E', C, D), with
    ``p``'s (E', in, out) banks: batched products with f32 results, SiLU
    and the gate product in f32 rounded once to ``dtype``, the down
    product's f32 result rounded once, as the reference casts."""
    hg = _bmm_f32(xe, p["w_gate"])
    hu = _bmm_f32(xe, p["w_up"])
    hy = (F.silu(hg) * hu).to(dtype)
    return _bmm_f32(hy, p["w_down"]).to(dtype)


def _moe_group(p: Params, xg: torch.Tensor, cfg: ModelConfig,
               capacity: int, experts: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """Route one group of tokens, xg (G, D) -> (G, D): ``moe_route``, the
    dispatch gather into (E, C, D), the experts' SwiGLU as batched products
    with f32 results (cuBLAS on the card), SiLU and the gate product in f32
    rounded once to x's dtype, the down product's f32 result rounded once,
    as the reference casts; the combine gather and the f32 weighted sum
    over the k experts.  ``experts`` = (e0, e1): only those experts run
    (the banks in ``p`` hold just them), the others' slots give zeros, so
    the result is this range's part of the sum (a mesh rank's experts)."""
    g, d = xg.shape
    e = cfg.n_experts
    e0, e1 = experts if experts is not None else (0, e)
    topw, token_for_slot, slot_for_tokk, _ = moe_route(p, xg, cfg, capacity)
    xpad = torch.cat([xg, xg.new_zeros((1, d))], dim=0)
    dispatched = xpad[token_for_slot[e0 * capacity:e1 * capacity]].reshape(
        e1 - e0, capacity, d)
    y = experts_fwd(p, dispatched, xg.dtype)
    ypad = torch.cat([y.new_zeros((e0 * capacity, d)),
                      y.reshape((e1 - e0) * capacity, d),
                      y.new_zeros(((e - e1) * capacity + 1, d))], dim=0)
    per_k = ypad[slot_for_tokk].reshape(g, cfg.top_k, d)
    return torch.einsum("gk,gkd->gd", topw, per_k.float()).to(xg.dtype)


def moe_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            group_size: Optional[int] = None,
            capacity_factor: Optional[float] = None) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D).  One group over all tokens by default;
    ``group_size`` routes groups of that many tokens in turn (a ragged
    remainder: one group), each with its own capacity.  Then the shared
    experts' SwiGLU MLP, added.  A DTensor ``x`` (a mesh run) takes
    ``_moe_mesh``: expert parallelism (``moe_ep.py``) under
    ``flags.MOE_IMPL == "ep"`` where the ``tp`` dim (> 1) divides the
    experts, else the gather dispatch over every token of the batch."""
    if isinstance(x, DTensor):
        if group_size is not None:
            raise ValueError("moe_fwd: group_size is a single-device option")
        return _moe_mesh(p, x, cfg, capacity_factor)
    if capacity_factor is None:
        capacity_factor = flags.MOE_CAPACITY
    b, t, d = x.shape
    flat = x.reshape(b * t, d)
    n = flat.shape[0]
    gsz = n if group_size is None else min(group_size, n)
    if n % gsz:
        gsz = n  # tiny/ragged inputs: one group
    cap = moe_capacity(gsz, cfg, capacity_factor)
    out = torch.cat([_moe_group(p, flat[i:i + gsz], cfg, cap)
                     for i in range(0, n, gsz)], dim=0).reshape(b, t, d)
    if cfg.n_shared_experts:
        out = out + mlp_fwd(p["shared"], x, "swiglu")
    return out



# ---------------------------------------------------------------------------
# Mamba2 (SSD: state space duality, chunked matmul form)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    """The reference's leaves and dtypes: ``a_log``, ``d_skip`` and
    ``dt_bias`` are f32 whatever the model's dtype."""
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    conv_dim = di + 2 * ns
    f32 = torch.float32
    return {
        # order: [z (di), x (di), B (ns), C (ns), dt (nh)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * ns + nh, dtype, device),
        "conv_w": (truncated_normal((cfg.ssm_conv_width, conv_dim), gen,
                                    device) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=device)),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: y_t = C_t . h_t,  h_t = exp(-exp(A) dt_t) h_{t-1} +
    dt_t B_t x_t, in f32.

    xh: (B, T, nh, hd); dt: (B, T, nh); bmat/cmat: (B, T, ns).  Returns
    (y (B, T, nh, hd), final state (B, nh, ns, hd)).  Within a chunk the
    work is attention-like products under decay weights (masked before the
    exp, so no entry above the diagonal overflows); across chunks a loop
    carries the (B, nh, ns, hd) state.  T must be a multiple of the chunk
    (or shorter than it), as the reference asserts."""
    b, t, nh, hd = xh.shape
    ns = bmat.shape[-1]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"ssd_scan: T = {t} is not a multiple of the SSD "
                         f"chunk {q}")
    dev = xh.device
    a = -torch.exp(a_log.float())                          # (nh,)
    dtf = dt.float()
    dta = dtf * a                                          # (B, T, nh)
    xdt = xh.float() * dtf[..., None]                      # dt-weighted input
    bf, cf = bmat.float(), cmat.float()
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    h = (init_state.float() if init_state is not None
         else torch.zeros((b, nh, ns, hd), dtype=torch.float32, device=dev))
    ys = []
    for c0 in range(0, t, q):
        xq, dq = xdt[:, c0:c0 + q], dta[:, c0:c0 + q]
        bq, cq = bf[:, c0:c0 + q], cf[:, c0:c0 + q]
        cs = torch.cumsum(dq, dim=1)                       # (B, q, nh)
        total = cs[:, -1]                                  # (B, nh)
        li = cs[:, :, None, :] - cs[:, None, :, :]         # (B, q, q, nh)
        li = torch.where(mask[None, :, :, None], li,
                         torch.full_like(li, float("-inf")))
        w = torch.exp(li)
        scores = torch.einsum("bqs,bks->bqk", cq, bq)      # (B, q, q)
        y_intra = torch.einsum("bqk,bqkh,bkhd->bqhd", scores, w, xq)
        y_inter = torch.einsum("bqs,bhsd,bqh->bqhd", cq, h, torch.exp(cs))
        decay_to_end = torch.exp(total[:, None, :] - cs)   # (B, q, nh)
        s_new = torch.einsum("bqs,bqhd,bqh->bhsd", bq, xq, decay_to_end)
        h = torch.exp(total)[:, :, None, None] * h + s_new
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def mamba2_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               state: Optional[Params] = None, layer: Optional[int] = None,
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Mamba2 block; state: {"ssm": (B, nh, ns, hd) f32, "conv": (B, w-1,
    conv_dim)}.  Without a state: the chunked scan over the sequence, and
    the state it ends in returned (None below w - 1 positions, as in the
    reference).  With one (decode, one position): the one-step recurrence,
    the state updated in place and returned.  A DTensor ``x`` (a mesh
    run) without a state runs replicated over the ``tp`` dim
    (``_replicated_mesh``), with a placed one ``_mamba2_decode_mesh``
    (``layer`` names the layer in its errors)."""
    if isinstance(x, DTensor):
        if state is not None:
            return _mamba2_decode_mesh(p, x, cfg, state, layer), state
        return _replicated_mesh(
            lambda pf, xl: mamba2_fwd(pf, xl, cfg)[0],
            p, specs_mamba2(cfg, S.tp_size()), x), None
    if state is not None:
        y = _mamba2_step(p, x, cfg, state, 0, cfg.n_ssm_heads, p["norm"])
        return apply_linear(p["out_proj"], y), state
    b, t, _ = x.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd = cfg.ssm_head_dim
    w = cfg.ssm_conv_width
    zxbcdt = apply_linear(p["in_proj"], x)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * ns]
    dt_raw = zxbcdt[..., 2 * di + 2 * ns:]
    xbc_pad = torch.cat([xbc.new_zeros((b, w - 1, xbc.shape[-1])), xbc],
                        dim=1)
    conv = _mamba2_conv(p, xbc_pad, t, w)
    xs = conv[..., :di].reshape(b, t, nh, hd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    y, h = ssd_scan(xs, dt, p["a_log"], conv[..., di: di + ns],
                    conv[..., di + ns:], cfg.ssm_chunk)
    new_state = ({"ssm": h, "conv": xbc_pad[:, -(w - 1):, :].clone()}
                 if t >= w - 1 else None)
    y = y + p["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(b, t, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    return apply_linear(p["out_proj"], y), new_state


def _mamba2_conv(w: Params, xbc_pad: torch.Tensor, t: int, cw: int
                 ) -> torch.Tensor:
    """The depthwise causal conv1d of window ``cw`` over ``xbc_pad`` (the
    window's state, then the ``t`` new positions), the reference's order
    of sums, and its SiLU."""
    conv = xbc_pad[:, 0:t, :] * w["conv_w"][0]
    for i in range(1, cw):
        conv = conv + xbc_pad[:, i:i + t, :] * w["conv_w"][i]
    return F.silu(conv + w["conv_b"])


def _mamba2_step(w: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: Params, h0: int, nhl: int, norm: torch.Tensor,
                 gather=None) -> torch.Tensor:
    """The Mamba2 block's one-step recurrence (decode) on local tensors, up
    to ``out_proj``'s input: (B, 1, d_inner) after the gated RMSNorm
    (``norm``).  The in-projection and the convolution are whole; the SSM
    steps heads h0 .. h0 + nhl, ``w``'s dt_bias, a_log and d_skip and
    ``state["ssm"]`` holding just those; the state is updated in place.
    ``gather`` takes those heads' outputs (B, 1, nhl x head_dim) to all of
    d_inner (on a mesh, ``_mamba2_decode_mesh``: an all-gather over "tp");
    one device steps every head and needs none."""
    b, t, _ = x.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd, cw = cfg.ssm_head_dim, cfg.ssm_conv_width
    zxbcdt = apply_linear(w["in_proj"], x)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * ns]
    dt_raw = zxbcdt[..., 2 * di + 2 * ns + h0: 2 * di + 2 * ns + h0 + nhl]
    xbc_pad = torch.cat([state["conv"], xbc], dim=1)
    conv = _mamba2_conv(w, xbc_pad, t, cw)
    xs = conv[..., :di].reshape(b, t, nh, hd)[:, :, h0:h0 + nhl]
    bmat = conv[..., di: di + ns]
    cmat = conv[..., di + ns:]
    dt = F.softplus(dt_raw.float() + w["dt_bias"])
    da = torch.exp(dt[:, 0] * -torch.exp(w["a_log"].float()))   # (B, nhl)
    upd = torch.einsum("bs,bhd,bh->bhsd", bmat[:, 0].float(),
                       xs[:, 0].float(), dt[:, 0])
    hs = da[:, :, None, None] * state["ssm"].float() + upd
    y = torch.einsum("bs,bhsd->bhd", cmat[:, 0].float(), hs)[:, None]
    state["conv"].copy_(xbc_pad[:, -(cw - 1):, :])
    state["ssm"].copy_(hs)
    y = y + w["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(b, t, nhl * hd)
    if gather is not None:
        y = gather(y)
    y = y.to(x.dtype)
    return rms_norm(y * F.silu(z.float()).to(x.dtype), norm, cfg.norm_eps)


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    return {"ssm": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_state,
                                cfg.ssm_head_dim), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# logical partition specs, one ``specs_*`` per ``init_*`` (the reference's)
# ---------------------------------------------------------------------------

def _maybe(n: int, size: int, axis: str) -> Optional[str]:
    """Shard a dim of length n over ``axis`` only if ``size`` divides it."""
    return axis if size > 0 and n % size == 0 else None


def specs_attention(cfg: ModelConfig, tp: int) -> Params:
    hd = cfg.head_dim
    qo = _maybe(cfg.n_heads * hd, tp, "tp")
    kvo = _maybe(cfg.n_kv_heads * hd, tp, "tp")
    p = {"wq": P("fsdp", qo), "wk": P("fsdp", kvo), "wv": P("fsdp", kvo),
         "wo": P(qo, "fsdp")}
    if cfg.qkv_bias:
        p.update({"bq": P(qo), "bk": P(kvo), "bv": P(kvo)})
    return p


def specs_attention_cache(cfg: ModelConfig, tp: int) -> Params:
    # KV heads over the model dim where they divide it; else the sequence
    # (GQA kv=8 on tp=16), so long caches still split
    if tp and cfg.n_kv_heads % tp == 0:
        spec = P("dp", None, "tp", None)
    else:
        spec = P("dp", "sp", None, None)
    return {"k": spec, "v": spec}


def specs_mla(cfg: ModelConfig, tp: int) -> Params:
    qk_hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    h = cfg.n_heads
    p: Params = {}
    if cfg.q_lora_rank:
        p["q_a"] = P("fsdp", None)
        p["q_norm"] = P(None)
        p["q_b"] = P(None, _maybe(h * qk_hd, tp, "tp"))
    else:
        p["q_b"] = P("fsdp", _maybe(h * qk_hd, tp, "tp"))
    p["kv_a"] = P("fsdp", None)
    p["kv_norm"] = P(None)
    p["k_b"] = P(None, _maybe(h * cfg.qk_nope_head_dim, tp, "tp"))
    p["v_b"] = P(None, _maybe(h * cfg.v_head_dim, tp, "tp"))
    p["wo"] = P(_maybe(h * cfg.v_head_dim, tp, "tp"), "fsdp")
    return p


def specs_mla_cache(cfg: ModelConfig, tp: int) -> Params:
    # the latent cache has no head dim: the sequence over the model dim
    return {"c_kv": P("dp", "sp", None), "k_rope": P("dp", "sp", None)}


def specs_mlp(d_ff: int, act: str, tp: int) -> Params:
    f = _maybe(d_ff, tp, "tp")
    p = {"up": P("fsdp", f), "down": P(f, "fsdp")}
    if act == "swiglu":
        p["gate"] = P("fsdp", f)
    return p


def specs_moe(cfg: ModelConfig, tp: int) -> Params:
    e = _maybe(cfg.n_experts, tp, "tp")
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": P("fsdp", None), "w_gate": P(e, "fsdp", None),
         "w_up": P(e, "fsdp", None), "w_down": P(e, None, "fsdp")}
    if cfg.n_shared_experts:
        p["shared"] = specs_mlp(cfg.n_shared_experts * dff, "swiglu", tp)
    return p


def specs_mamba2(cfg: ModelConfig, tp: int) -> Params:
    nh = _maybe(cfg.n_ssm_heads, tp, "tp")
    di = _maybe(cfg.d_inner, tp, "tp")
    return {"in_proj": P("fsdp", None), "conv_w": P(None, None),
            "conv_b": P(None), "a_log": P(nh), "d_skip": P(nh),
            "dt_bias": P(nh), "norm": P(di), "out_proj": P(di, "fsdp")}


def specs_mamba2_state(cfg: ModelConfig, tp: int) -> Params:
    nh = _maybe(cfg.n_ssm_heads, tp, "tp")
    return {"ssm": P("dp", nh, None, None), "conv": P("dp", None, None)}


# ---------------------------------------------------------------------------
# the mesh paths: blocks on local shards, under ``sharding.use_rules``
#
# The residual stream is a DTensor (batch over "dp", sequence over "sp", as
# the transformer's ``constrain`` sites put it).  A block gathers the
# sequence it needs (``constrain(x, "dp", None, None)``), runs on its
# rank's weight shards (``_use`` gathers the "fsdp" dims), and returns its
# output in x's placements: a tp-sharded product's partial sums are
# reduce-scattered over the sequence, a replicated one's output is sliced.
# Every rank's slice of the stream is a disjoint part of the loss, so the
# collectives' adjoints (``collectives.py``) give each weight shard its
# whole gradient once the train step sums the replicated dims.
# ---------------------------------------------------------------------------

def _use(w, spec, keep_tp: bool = True):
    """Weight ``w`` (this rank's shard under ``spec``) gathered over every
    mesh dim it is sharded on, but the ``tp`` dim where ``keep_tp``.  A
    sparse leaf is the BCSR (or ELL) of this rank's ``tp`` shard, whole
    over every other mesh dim (what ``launch/sparse_weights.py`` builds),
    and is taken as it is: sparse weights run on a mesh only as whole
    shards.  A block that would gather one over ``tp`` raises."""
    mesh = S.get_mesh()
    names = S._dim_names(mesh)
    tp = S.tp_axis()
    out = w
    pls = S.placements(spec, mesh)
    sparse = isinstance(w, (BcsrMatrix, EllMatrix))
    for i in reversed(range(len(pls))):
        pl = pls[i]
        if not isinstance(pl, Shard) or (keep_tp and names[i] == tp):
            continue
        if S.axis_size(names[i]) == 1 or (sparse and names[i] != tp):
            continue
        if sparse:
            raise ValueError(
                f"a {type(out).__name__} weight is sharded over the tp dim "
                f"{names[i]!r}, which this block gathers; sparse weights "
                f"run on a mesh only as whole shards of a block that keeps "
                f"its tp shard")
        out = C.all_gather(out, pl.dim, names[i])
    return out


def _use_tree(p: Params, specs: Params, keep_tp: bool = True) -> Params:
    return {k: (_use_tree(v, specs[k], keep_tp) if isinstance(v, dict)
                else _use(v, specs[k], keep_tp)) for k, v in p.items()}


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[:2]
    return torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)


def _on_tp(xf: DTensor, pl) -> tuple:
    """xf's placements with the ``tp`` dim's set to ``pl``."""
    names = S._dim_names(S.get_mesh())
    out = list(xf.placements)
    ax = S.tp_axis()
    if ax is not None:
        out[names.index(ax)] = pl
    return tuple(out)


def _tp_out(y: torch.Tensor, xf: DTensor, partial: bool, x: DTensor
            ) -> DTensor:
    """A block's local output ``y`` on the gathered layout of ``xf``: the
    partial sums of a tp-sharded product (``partial``) or a replicated
    result, in x's placements."""
    y = S.wrap(y, _on_tp(xf, Partial() if partial else Replicate()))
    return S.redistribute(y, x.placements)


def tp_attention_mode(h: int, kv: int, tp: int) -> Optional[str]:
    """The reference's regimes of the tensor-parallel attention: "A" whole
    kv groups a rank (kv heads sharded), "B" a rank's q heads inside one kv
    group (each rank takes its single kv head), None where ``tp`` does not
    divide the heads or neither fits (the chunked attention, replicated)."""
    if h % tp:
        return None
    hq, g = h // tp, h // kv
    if hq % g == 0:
        return "A"
    if g % hq == 0:
        return "B"
    return None


def _attention_mesh(p: Params, x: DTensor, cfg: ModelConfig) -> DTensor:
    """GQA attention on a mesh.  Modes A and B (``tp_attention_mode``): the
    rank's h / tp query heads and its kv heads (A: kv / tp of them; B: kv
    head (rank * h / tp) // g, cut from the gathered wk / wv), the flash or
    chunked attention on them, the partial output projection.  Otherwise
    every rank runs the whole attention with gathered weights through the
    chunked path, as the reference falls back, and keeps its slice."""
    tp = S.tp_size()
    specs = specs_attention(cfg, tp)
    xf = S.constrain(x, "dp", None, None)
    xl = xf.to_local()
    b, t, _ = xl.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mode = tp_attention_mode(h, kv, tp)
    if mode is None:
        w, hq, kvq = _use_tree(p, specs, keep_tp=False), h, kv
    else:
        w, hq, kvq = _use_tree(p, specs), h // tp, kv // tp
    if mode == "B":
        idx = (S.axis_index(S.tp_axis()) * hq) // (h // kv)
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                w[name] = _use(p[name], specs[name], keep_tp=False)[
                    ..., idx * hd:(idx + 1) * hd]
        kvq = 1
    pos = _positions(xl)
    q = rope(apply_linear(w["wq"], xl, w.get("bq")).reshape(b, t, hq, hd),
             pos, cfg.rope_theta)
    k = rope(apply_linear(w["wk"], xl, w.get("bk")).reshape(b, t, kvq, hd),
             pos, cfg.rope_theta)
    v = apply_linear(w["wv"], xl, w.get("bv")).reshape(b, t, kvq, hd)
    attend = full_attention if mode is not None else chunked_attention
    out = attend(q, k, v, causal=cfg.causal)
    y = apply_linear(w["wo"], out.reshape(b, t, hq * hd))
    return _tp_out(y, xf, mode is not None, x)


def _mlp_mesh(p: Params, x: DTensor, act: str, d_ff: int) -> DTensor:
    """The MLP on a mesh: the rank's d_ff columns of up / gate and rows of
    down (partial sums), or the whole MLP where tp does not divide d_ff."""
    specs = specs_mlp(d_ff, act, S.tp_size())
    xf = S.constrain(x, "dp", None, None)
    sharded = specs["up"][1] is not None
    y = mlp_fwd(_use_tree(p, specs, keep_tp=sharded), xf.to_local(), act)
    return _tp_out(y, xf, sharded, x)


def _moe_mesh(p: Params, x: DTensor, cfg: ModelConfig,
              capacity_factor: Optional[float]) -> DTensor:
    """The MoE on a mesh.  ``flags.MOE_IMPL == "ep"`` with tp > 1 dividing
    the experts: ``moe_ep.moe_fwd_ep``.  Otherwise the reference's gather
    dispatch as one group over every token of the global batch (its
    capacity and drops are the single device's): each rank routes them all
    and runs its experts (the dispatch buffers' expert dim on "tp"); each
    rank combines its experts' part and the partial sums are
    reduce-scattered to x's placements.  ``flags.MOE_CONSTRAIN`` changes
    nothing here: the reference's constraint is a layout hint that pins
    the dispatch buffers' expert dim to "tp", which this explicit layout
    always does.  Then the shared experts' MLP."""
    tp = S.tp_size()
    if flags.MOE_IMPL == "ep" and tp > 1 and cfg.n_experts % tp == 0:
        from repro_torch.models.moe_ep import moe_fwd_ep
        return moe_fwd_ep(p, x, cfg)
    if capacity_factor is None:
        capacity_factor = flags.MOE_CAPACITY
    specs = specs_moe(cfg, tp)
    xa = S.constrain(x, None, None, None)
    xl = xa.to_local()
    b, t, d = xl.shape
    flat = xl.reshape(b * t, d)
    cap = moe_capacity(b * t, cfg, capacity_factor)
    sharded = specs["w_gate"][0] is not None
    e_loc = cfg.n_experts // tp if sharded else cfg.n_experts
    e0 = S.axis_index(S.tp_axis()) * e_loc if sharded else 0
    pl = _use_tree({k: p[k] for k in ("router", "w_gate", "w_up", "w_down")},
                   specs)
    out = _moe_group(pl, flat, cfg, cap, experts=(e0, e0 + e_loc))
    y = _tp_out(out.reshape(b, t, d), xa, sharded, x)
    if cfg.n_shared_experts:
        dff = cfg.moe_d_ff or cfg.d_ff
        y = y + _mlp_mesh(p["shared"], x, "swiglu",
                          cfg.n_shared_experts * dff)
    return y


def _replicated_mesh(fn, p: Params, specs: Params, x: DTensor) -> DTensor:
    """A mixer whose tensor-parallel split is not ported for full
    sequences (MLA, Mamba2): its weights gathered whole, ``fn(weights,
    local x)`` run on every rank of the ``tp`` dim over the gathered
    sequence, each keeping its slice."""
    xf = S.constrain(x, "dp", None, None)
    y = fn(_use_tree(p, specs, keep_tp=False), xf.to_local())
    return _tp_out(y, xf, False, x)


# ---------------------------------------------------------------------------
# decode on a mesh: one position (T 1) a step, the cache placed by
# ``transformer.cache_specs`` (``steps.place_cache``), its local tensors
# updated in place.  The residual stream at T 1 keeps its batch over "dp"
# and is whole over "sp" (a length-1 sequence does not split).
#
# A cache whose sequence is split over "tp" (a GQA cache whose KV heads
# "tp" does not divide, every MLA latent cache) is written at global
# position ``cur_len`` by the one rank whose slice holds it, and each rank
# attends over its own slice for every query head (the query projected on
# the rank's weight columns and gathered over "tp": a few KB at T 1),
# keeping its f32 (max, sum, unnormalised output); the slices combine by
# log-sum-exp over "tp" (``_lse_combine``), and each rank multiplies its
# rows of the output projection, whose partial sums are reduced as in
# prefill.
# ---------------------------------------------------------------------------

def _tp_placement(t: DTensor):
    """``t``'s placement on the ``tp`` dim (Replicate where it is absent or
    of size 1)."""
    ax = S.tp_axis()
    if ax is None or S.axis_size(ax) == 1:
        return Replicate()
    return t.placements[S._dim_names(t.device_mesh).index(ax)]


def _seq_split(t: DTensor) -> bool:
    pl = _tp_placement(t)
    return isinstance(pl, Shard) and pl.dim == 1


def _cache_locals(cache: Params, xl: torch.Tensor, cfg: ModelConfig,
                  layer: Optional[int], what: str) -> Params:
    """The local tensors of a placed cache, checked against the block's
    input: DTensors (``steps.place_cache``) whose batch shard is the
    input's, at one position a step."""
    where = f"{cfg.name}: layer {layer}"
    if xl.shape[1] != 1:
        raise ValueError(f"{where}: a meshed decode takes one position a "
                         f"step, got {xl.shape[1]}")
    out = {}
    for k, v in cache.items():
        if not isinstance(v, DTensor):
            raise ValueError(
                f"{where}: a meshed decode takes its {what} placed on the "
                f"mesh (steps.place_cache); {k!r} is a {type(v).__name__}")
        loc = v.to_local()
        if loc.shape[0] != xl.shape[0]:
            raise ValueError(
                f"{where}: the {what}'s {k!r} holds {loc.shape[0]} rows a "
                f"rank and the block's input {xl.shape[0]}: the tokens and "
                f"the {what} must split the batch alike")
        out[k] = loc
    return out


def _decode_positions(xl: torch.Tensor, cur_len: int) -> torch.Tensor:
    return torch.full(xl.shape[:2], int(cur_len), dtype=torch.int32,
                      device=xl.device)


def _write_seq_shard(cache: torch.Tensor, new: torch.Tensor, cur_len: int,
                     rank: int, n: int) -> None:
    """Write ``new`` (B, 1, ...) at global position ``cur_len`` of a cache
    whose sequence is split in ``n`` slices, this rank holding slice
    ``rank``: only the owner writes.  The start is clamped to S - 1, as
    ``write_cache`` (``lax.dynamic_update_slice``) clamps it."""
    s_loc = cache.shape[1]
    lo = max(0, min(int(cur_len), s_loc * n - 1)) - rank * s_loc
    if 0 <= lo < s_loc:
        cache[:, lo:lo + 1] = new


def _attend_shard(logits: torch.Tensor, n_valid: int, pv
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``logits`` (..., S_loc) over one slice, its first ``n_valid``
    positions valid -> (max, sum of exponentials, ``pv(p)``: the
    unnormalised output) of the slice."""
    s = logits.shape[-1]
    mask = torch.arange(s, device=logits.device) < n_valid
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), pv(p)


def _lse_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                 ax: str) -> torch.Tensor:
    """The softmax-weighted output (..., dv) over every rank's slice of
    ``ax`` from each slice's (max, sum, unnormalised output): each part
    weighted by exp(m - m_global).  A slice with no valid position has
    logits all the finite ``NEG_INF``, so its own softmax would be uniform;
    its weight exp(NEG_INF - m_global) is exactly 0.  One max and one sum
    over ``ax``."""
    wgt = torch.exp(m - C.value_max(m, [ax]))
    both = C.all_reduce(torch.cat([acc * wgt[..., None],
                                   (l * wgt)[..., None]], dim=-1), ax)
    return both[..., :-1] / both[..., -1:]


def _gather_cols(y: torch.Tensor, entry, ax: Optional[str]) -> torch.Tensor:
    """A projection's output on this rank's weight columns, gathered over
    ``ax`` where the weight's spec ``entry`` splits its columns."""
    return y if entry is None or ax is None else C.all_gather(y, y.ndim - 1,
                                                              ax)


def _own_cols(y: torch.Tensor, entry, ax: Optional[str]) -> torch.Tensor:
    """This rank's chunk of ``y``'s last dim where a weight's spec
    ``entry`` splits its rows over ``ax`` (the rows it multiplies)."""
    if entry is None or ax is None or S.axis_size(ax) == 1:
        return y
    n = y.shape[-1] // S.axis_size(ax)
    r = S.axis_index(ax)
    return y[..., r * n:(r + 1) * n]


def _attention_decode_mesh(p: Params, x: DTensor, cfg: ModelConfig,
                           cache: Params, cur_len: int,
                           layer: Optional[int]) -> DTensor:
    """One GQA decode step on a mesh.  A cache with its KV heads over "tp"
    (kv % tp == 0, mode A): each rank projects its h / tp query heads and
    kv / tp KV heads, writes its K/V shard at ``cur_len`` and attends on
    its heads (``decode_attention``), the output projection's partial sums
    reduced.  A cache with its sequence over "tp": the section's comment
    above."""
    tp, ax = S.tp_size(), S.tp_axis()
    specs = specs_attention(cfg, tp)
    xf = S.constrain(x, "dp", None, None)
    xl = xf.to_local()
    b, t, _ = xl.shape
    kc = _cache_locals(cache, xl, cfg, layer, "KV cache")
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = _decode_positions(xl, cur_len)
    w = _use_tree(p, specs)
    if not _seq_split(cache["k"]):
        if kc["k"].shape[2] * tp != kv:
            raise ValueError(
                f"{cfg.name}: layer {layer}: the KV cache holds "
                f"{kc['k'].shape[2]} KV heads a rank of {kv} over tp {tp}; "
                f"place it by transformer.cache_specs")
        hq, kvq = h // tp, kv // tp
        q = rope(apply_linear(w["wq"], xl, w.get("bq")).reshape(b, t, hq, hd),
                 pos, cfg.rope_theta)
        k = rope(apply_linear(w["wk"], xl, w.get("bk")).reshape(b, t, kvq,
                                                                hd),
                 pos, cfg.rope_theta)
        v = apply_linear(w["wv"], xl, w.get("bv")).reshape(b, t, kvq, hd)
        write_cache(kc["k"], k, cur_len)
        write_cache(kc["v"], v, cur_len)
        out = decode_attention(q, kc["k"], kc["v"], cur_len + 1)
        y = apply_linear(w["wo"], out.reshape(b, t, hq * hd))
        return _tp_out(y, xf, tp > 1, x)
    # the sequence over "tp": every query head on every rank
    q = _gather_cols(apply_linear(w["wq"], xl, w.get("bq")), specs["wq"][1],
                     ax).reshape(b, t, h, hd)
    k = _gather_cols(apply_linear(w["wk"], xl, w.get("bk")), specs["wk"][1],
                     ax).reshape(b, t, kv, hd)
    v = _gather_cols(apply_linear(w["wv"], xl, w.get("bv")), specs["wv"][1],
                     ax).reshape(b, t, kv, hd)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    r = S.axis_index(ax)
    _write_seq_shard(kc["k"], k, cur_len, r, tp)
    _write_seq_shard(kc["v"], v, cur_len, r, tp)
    qf = q.reshape(b, kv, h // kv, hd).float() * hd ** -0.5
    vf = kc["v"].float()
    m, l, acc = _attend_shard(
        torch.einsum("bkgd,bskd->bkgs", qf, kc["k"].float()),
        cur_len + 1 - r * kc["k"].shape[1],
        lambda pr: torch.einsum("bkgs,bskd->bkgd", pr, vf))
    out = _lse_combine(m, l, acc, ax).reshape(b, t, h * hd).to(q.dtype)
    y = apply_linear(w["wo"], _own_cols(out, specs["wo"][0], ax))
    return _tp_out(y, xf, specs["wo"][0] is not None, x)


def _mla_decode_mesh(p: Params, x: DTensor, cfg: ModelConfig, cache: Params,
                     cur_len: int, layer: Optional[int]) -> DTensor:
    """One absorbed MLA decode step on a mesh (``_mla_absorbed``), its
    latent cache split by sequence over "tp".  Where "tp" divides the
    heads, each rank projects its heads' queries (q_b's columns) and
    absorbs them through its k_b columns; the absorbed queries are
    gathered over "tp", each rank attends over its cache slice for every
    head, the slices combine by log-sum-exp, and each rank expands its
    heads' latent outputs through its v_b columns and its rows of wo
    (partial sums, reduced).  Otherwise the weights are gathered whole and
    every rank runs every head."""
    _dense_kv_b(p, cfg, layer)
    tp, ax = S.tp_size(), S.tp_axis()
    split = tp > 1 and cfg.n_heads % tp == 0
    w = _use_tree(p, specs_mla(cfg, tp), keep_tp=split)
    xf = S.constrain(x, "dp", None, None)
    xl = xf.to_local()
    cl = _cache_locals(cache, xl, cfg, layer, "latent cache")
    n = S.axis_size(ax) if _seq_split(cache["c_kv"]) else 1
    out = _mla_absorbed(w, xl, _decode_positions(xl, cur_len), cfg, cl,
                        cur_len, ax=ax, split=split, n=n)
    return _tp_out(apply_linear(w["wo"], out), xf, split, x)


def _mamba2_decode_mesh(p: Params, x: DTensor, cfg: ModelConfig,
                        state: Params, layer: Optional[int]) -> DTensor:
    """One Mamba2 decode step on a mesh, the state placed by
    ``specs_mamba2_state``.  Where its SSM heads are over "tp", each rank
    computes the whole in-projection and the convolution (the conv state
    is replicated over "tp": every rank writes the same window), steps
    its heads' SSM state in place, and gathers the heads' outputs over
    "tp" (B x d_inner values) for the gated RMSNorm over all of d_inner;
    it multiplies its chunk by its rows of out_proj, the partial sums
    reduced.  Otherwise the weights are gathered whole and every rank
    steps every head."""
    tp, ax = S.tp_size(), S.tp_axis()
    split = tp > 1 and _tp_placement(state["ssm"]) == Shard(1)
    specs = specs_mamba2(cfg, tp)
    w = _use_tree(p, specs, keep_tp=split)
    xf = S.constrain(x, "dp", None, None)
    xl = xf.to_local()
    st = _cache_locals(state, xl, cfg, layer, "SSM state")
    nhl = st["ssm"].shape[1]
    h0 = S.axis_index(ax) * nhl if split else 0
    norm = (_use(p["norm"], specs["norm"], keep_tp=False) if split
            else w["norm"])
    y = _mamba2_step(w, xl, cfg, st, h0, nhl, norm,
                     (lambda yl: C.all_gather(yl, 2, ax)) if split else None)
    out = apply_linear(w["out_proj"],
                       _own_cols(y, specs["out_proj"][0] if split else None,
                                 ax))
    return _tp_out(out, xf, split, x)
