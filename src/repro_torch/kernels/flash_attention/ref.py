"""Plain PyTorch versions of the flash-attention kernels.

``flash_attention_plain`` takes the kernel's operands and returns what the
kernel returns, (O, lse), from whole rows instead of an online softmax over
chunks: ``s = (q * sc) k^T`` in f32, the causal mask at -1e30, ``m`` the row
max, ``l = max(sum exp(s - m), 1e-30)``, ``O = (exp(s - m) v) / l`` cast to
q's dtype and ``lse = m + log l``.  The online softmax rescales partial sums
chunk by chunk, so the two agree to f32 rounding.  It holds the (B, H, T, S)
f32 scores at once, which the kernel never does.

``flash_attention_bwd_plain`` takes the backward kernels' operands and
returns what they return, (dQ, dK, dV), by the recompute formulation of the
reference's ``_bwd_call`` on whole rows, in f32: ``P = exp((q * sc) k^T -
lse)`` under the same mask, ``delta = rowsum(dO * O)``, ``dS = P * (dP -
delta)`` with ``dP = dO v^T``, ``dQ = dS k * sc``, ``dK = dS^T q * sc`` and
``dV = P^T dO``, dK and dV summed over the G query heads of each kv head.

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


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              sc: float, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """q, o, do (B, H, T, d), k/v (B, KV, S, d), lse (B, H, T) f32 ->
    dQ (B, H, T, d), dK, dV (B, KV, S, d) in the dtypes of q, k and v."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, kv, g, t, d).float()
    dof = do.reshape(b, kv, g, t, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    logits = torch.matmul(qf * sc, kf.transpose(-1, -2))     # (B,KV,G,T,S)
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - lse.reshape(b, kv, g, t, 1))
    del logits
    delta = (dof * o.reshape(b, kv, g, t, d).float()).sum(dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    del dp
    dq = torch.matmul(ds, kf) * sc
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2) * sc
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    return (dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
