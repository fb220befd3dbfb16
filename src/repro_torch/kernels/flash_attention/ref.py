"""Plain PyTorch versions of the flash-attention forward kernel.

``flash_attention_plain`` takes the kernel's operands and returns what the
kernel returns, (O, lse), from whole rows instead of an online softmax over
chunks: ``s = (q * sc) k^T`` in f32, the causal mask at -1e30, ``m`` the row
max, ``l = max(sum exp(s - m), 1e-30)``, ``O = (exp(s - m) v) / l`` cast to
q's dtype and ``lse = m + log l``.  The online softmax rescales partial sums
chunk by chunk, so the two agree to f32 rounding.  It holds the (B, H, T, S)
f32 scores at once, which the kernel never does.

``attention_ref`` is the port of the reference's oracle
(``repro/kernels/flash_attention/ref.py``): naive softmax attention.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, sc: float, causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, T, d), k/v (B, KV, S, d) -> O (B, H, T, d) in q's dtype and
    lse (B, H, T) f32; query head h reads kv head h // (H / KV)."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, kv, g, t, d).float() * sc
    logits = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.matmul(p, v.float()[:, :, None]) / l[..., None]
    lse = m + torch.log(l)
    return (out.reshape(b, h, t, d).to(q.dtype), lse.reshape(b, h, t))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, T, d), k/v (B, KV, S, d) -> (B, H, T, d), float32 math."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf = q.reshape(b, kv, g, t, d).float() * scale
    logits = torch.einsum("bkgtd,bksd->bkgts", qf, k.float())
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return out.reshape(b, h, t, d).to(q.dtype)
