"""Model building blocks of the dense-attention transformers.

Port of the part of ``repro/models/layers.py`` the dense path needs:
linear application over dense, BCSR and ELL weights, RMSNorm, RoPE, the
full-sequence attention (the flash kernel or the chunked online softmax),
decode attention over a KV cache, the GQA attention block and the MLP.
MLA, MoE and Mamba2 wait for a later slice.

Conventions, as in the reference: params are nested dicts of tensors;
dense linear weights are (in_features, out_features), so application is
``x @ w``; ``BcsrMatrix`` / ``EllMatrix`` leaves have the logical shape
(out, in) and go through the Escoin sparse path.  Weights are drawn with a
``torch.Generator`` from the reference's distributions; the values differ
from ``jax.random``'s, so a comparison carries the reference's params over
(``transformer.params_from_reference``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BcsrMatrix, EllMatrix
from repro_torch.core.sparse_linear import ell_matmul
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

    Dense (in, out) tensor -> ``x @ w`` with f32 accumulate, cast to x's
    dtype (cuBLAS on the card, as the reference leaves it to XLA).
    ``BcsrMatrix`` of logical shape (out, in) -> the ``bsr_matmul`` kernel;
    ``EllMatrix`` -> ``ell_matmul``.
    """
    if isinstance(w, BcsrMatrix):
        y = bsr_matmul(x, w)
    elif isinstance(w, EllMatrix):
        y = ell_matmul(x, w)
    else:  # bf16 products accumulate in f32 in cuBLAS and on the CPU
        y = torch.matmul(x, w)
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
    reference (the port runs on one card: no head sharding)."""
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
                  cur_len: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention.  Without a cache: full-sequence attention.  With one:
    K and V of the new position are written into the cache in place, at the
    shared position ``cur_len`` of every row, and the block attends over
    ``cur_len + 1`` positions; the cache is returned."""
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


def mlp_fwd(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = apply_linear(p["up"], x)
    if act == "swiglu":
        h = F.silu(apply_linear(p["gate"], x)) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return apply_linear(p["down"], h)
