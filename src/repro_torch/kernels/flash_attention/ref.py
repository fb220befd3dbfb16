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

``flash_attention_split_plain`` and ``flash_attention_bwd_split_plain``
mirror the arithmetic of the tensor-core kernels on whole rows: q k^T (and
dO v^T) from bf16 operands with f32 sums, which is exact products, then
``sc``; every product with an f32 operand (p v, dS k, p^T dO, dS^T q) as
two bf16 products, of ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, summed in
f32.  With ``lo=False`` the products
take ``hi`` alone: p and dS rounded to bf16 once, the control that the
precision checks must reject.  They are used by the tests and
``chip_smoke.py``, never on the main path.

``flash_attention_bwd_tf32_plain`` mirrors the split-TF32 backward kernels
(f32 operands) on whole rows: every product (q k^T, dO v^T, dS k, dS^T q,
p^T dO) as three TF32 products of both operands' halves as the tensor
cores read them, ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``tf32``: an
f32 word read as .tf32, its low 13 bits cleared), hi hi + hi lo + lo hi;
dQ, dK and dV summed a chunk of keys or query rows at a time
(``budget.flash_tf32_chunk``), each chunk's sum rounded to f32 and added in
order.  With ``lo=False`` every product is one TF32 product of the
operands read once, the control the precision checks must reject.
``flash_attention_fwd_tf32_plain`` mirrors the split-TF32 forward the same
way, chunk of keys by chunk with the online softmax: s = q k^T and each
chunk's p v as three TF32 products, O = alpha O + (p v) in f32.

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


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (hi, lo) as f32 values: hi = bf16(x), lo = bf16(x - hi),
    so hi + lo keeps about 16 bits of x's mantissa."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_matmul(x: torch.Tensor, y: torch.Tensor, lo: bool) -> torch.Tensor:
    """x @ y as the tensor-core kernels take it: x split in two bf16
    halves, both products summed in f32 (``lo=False``: the hi half
    alone)."""
    hi_x, lo_x = split_bf16(x)
    out = torch.matmul(hi_x, y)
    return out + torch.matmul(lo_x, y) if lo else out


def _causal_logits(qf, kf, sc, causal):
    """(q k^T) sc on (B, KV, G, T, d) / (B, KV, 1, S, d) f32, masked."""
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * sc
    if causal:
        t, s = qf.shape[-2], kf.shape[-2]
        mask = (torch.arange(t, device=qf.device)[:, None]
                >= torch.arange(s, device=qf.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return logits


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, sc: float, causal: bool,
                                lo: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core forward's arithmetic on whole rows: q (B, H, T, d),
    k/v (B, KV, S, d) -> f32 O (B, H, T, d) and lse (B, H, T)."""
    b, h, t, d = q.shape
    kv = k.shape[1]
    g = h // kv
    logits = _causal_logits(q.reshape(b, kv, g, t, d).float(),
                            k.float()[:, :, None], sc, causal)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    del logits
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = _split_matmul(p, v.float()[:, :, None], lo) / l[..., None]
    return out.reshape(b, h, t, d), (m + torch.log(l)).reshape(b, h, t)


def flash_attention_bwd_split_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, o: torch.Tensor,
                                    lse: torch.Tensor, do: torch.Tensor, *,
                                    sc: float, causal: bool, lo: bool = True
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The tensor-core backward kernels' arithmetic on whole rows: the
    operands of ``flash_attention_bwd_plain`` -> f32 dQ (B, H, T, d), dK,
    dV (B, KV, S, d)."""
    b, h, t, d = q.shape
    kv = k.shape[1]
    g = h // kv
    qf = q.reshape(b, kv, g, t, d).float()
    dof = do.reshape(b, kv, g, t, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    p = torch.exp(_causal_logits(qf, kf, sc, causal)
                  - lse.reshape(b, kv, g, t, 1))
    delta = (dof * o.reshape(b, kv, g, t, d).float()).sum(dim=-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = _split_matmul(ds, kf, lo) * sc
    dk = _split_matmul(ds.transpose(-1, -2), qf, lo).sum(dim=2) * sc
    dv = _split_matmul(p.transpose(-1, -2), dof, lo).sum(dim=2)
    return dq.reshape(b, h, t, d), dk, dv


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as the tensor cores read an f32 word as .tf32: its low 13
    bits cleared (toward zero); infinities and NaNs as they are."""
    bits = x.float().contiguous().view(torch.int32)
    read = torch.bitwise_and(bits, ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), read, x.float())


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (hi, lo) = (tf32(x), tf32(x - tf32(x))), the kernels'
    halves as the tensor cores read them (the kernels pass x itself and the
    exact x - tf32(x)): hi + lo keeps about 20 bits of x's mantissa, hi
    alone 11."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def _tf32_matmul(x: torch.Tensor, y: torch.Tensor, lo: bool) -> torch.Tensor:
    """x @ y as the split-TF32 kernels take it: hi_x hi_y + hi_x lo_y +
    lo_x hi_y (each product of two TF32 values exact, summed in f64 here
    and rounded once to f32); ``lo=False``: tf32(x) @ tf32(y)."""
    hx, lx = split_tf32(x)
    hy, ly = split_tf32(y)
    out = torch.matmul(hx.double(), hy.double())
    if lo:
        out = (out + torch.matmul(hx.double(), ly.double())
               + torch.matmul(lx.double(), hy.double()))
    return out.float()


def _tf32_chunked(x: torch.Tensor, y: torch.Tensor, chunk: int,
                  lo: bool) -> torch.Tensor:
    """x @ y summed over ``chunk``-wide slices of the contraction, each
    slice's product rounded to f32 and added in order in f32 (the kernels'
    fresh partial a chunk)."""
    acc = None
    for c0 in range(0, x.shape[-1], chunk):
        part = _tf32_matmul(x[..., c0:c0 + chunk], y[..., c0:c0 + chunk, :],
                            lo)
        acc = part if acc is None else acc + part
    return acc


def flash_attention_bwd_tf32_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   sc: float, causal: bool, lo: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The split-TF32 backward kernels' arithmetic on whole rows: the
    operands of ``flash_attention_bwd_plain`` (f32) -> f32 dQ (B, H, T, d),
    dK, dV (B, KV, S, d)."""
    from repro_torch.kernels import budget

    b, h, t, d = q.shape
    kv = k.shape[1]
    g = h // kv
    chunk = budget.flash_tf32_chunk(d)
    qf = q.reshape(b, kv, g, t, d).float()
    dof = do.reshape(b, kv, g, t, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    logits = _tf32_matmul(qf, kf.transpose(-1, -2), lo) * sc
    if causal:
        s = kf.shape[-2]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - lse.reshape(b, kv, g, t, 1))
    del logits
    delta = (dof * o.reshape(b, kv, g, t, d).float()).sum(dim=-1)
    ds = p * (_tf32_matmul(dof, vf.transpose(-1, -2), lo) - delta[..., None])
    dq = _tf32_chunked(ds, kf, chunk, lo) * sc
    dk = _tf32_chunked(ds.transpose(-1, -2), qf, chunk, lo).sum(dim=2) * sc
    dv = _tf32_chunked(p.transpose(-1, -2), dof, chunk, lo).sum(dim=2)
    return dq.reshape(b, h, t, d), dk, dv


def flash_attention_fwd_tf32_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, sc: float,
                                   causal: bool, lo: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-TF32 forward kernel's arithmetic, a chunk of keys at a
    time: q (B, H, T, d), k/v (B, KV, S, d) f32 -> f32 O (B, H, T, d) and
    lse (B, H, T)."""
    from repro_torch.kernels import budget

    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    chunk = budget.flash_tf32_chunk(d)
    qf = q.reshape(b, kv, g, t, d).float()
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    m = torch.full((b, kv, g, t), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, t), device=q.device)
    acc = torch.zeros((b, kv, g, t, d), device=q.device)
    for c0 in range(0, s, chunk):
        kc, vc = kf[..., c0:c0 + chunk, :], vf[..., c0:c0 + chunk, :]
        x = _tf32_matmul(qf, kc.transpose(-1, -2), lo) * sc
        if causal:
            mask = (torch.arange(t, device=q.device)[:, None]
                    >= torch.arange(c0, c0 + kc.shape[-2],
                                    device=q.device)[None, :])
            x = torch.where(mask, x, torch.full_like(x, NEG_INF))
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _tf32_matmul(p, vc, lo)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return ((acc / l[..., None]).reshape(b, h, t, d),
            (m + torch.log(l)).reshape(b, h, t))


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
