"""Wrapper in the model's layout: (B, T, H, hd) <-> the kernel's (B, H, T, hd).

Port of ``repro/kernels/flash_attention/ops.py``.  The reference picks its
chunk sizes from VMEM (``choose_chunks``) and needs T and S to be multiples
of them; the CUDA kernels' chunks are fixed by their shared memory
(128 query rows a block, ``budget.flash_tf32_chunk`` or
``budget.FLASH_TC_BK`` keys a chunk) and they bounds-test ragged T and S,
so every row is computed whatever the length.

``FlashAttention`` is the port of the reference's ``jax.custom_vjp``
(``flash_attention``): its forward runs the forward kernel and saves the
reference's residuals (q, k, v, O, lse); its backward runs the dQ and
dK/dV kernels (on CPU tensors, the plain versions of all three).

The kernels take any head dim whose rows are a multiple of 16 bytes (up
to 128 in an instantiation, above it through the output-column split).
For another head dim (20, 30 or 132 in bf16; 30 or 130 in f32)
``flash_attention_bthd`` copies q, k and v once, zero filled to the next
multiple of 8 columns, and keeps the first hd columns of O (the zero
columns add nothing to q k^T; the scale stays hd's); that padded copy
still goes through the kernels, and autograd carries the gradients back
through it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)


class FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v) on (B, H, T, d) / (B, KV, S, d) operands,
    differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, sc: float, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, sc=sc, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sc, ctx.causal = sc, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the kernels take any strides but need a contiguous last axis
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(q.dtype),
                                         sc=ctx.sc, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, H, hd), k/v (B, S, KV, hd) -> (B, T, H, hd).  The
    transposes are views: the kernels read and write the model's layout
    (a head dim whose rows are no multiple of 16 bytes is padded first)."""
    hd = q.shape[-1]
    sc = scale if scale is not None else hd ** -0.5
    pad = (-hd) % 8 if hd * q.element_size() % 16 else 0
    if pad and q.device.type != "meta":
        q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    out = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), sc, causal).transpose(1, 2)
    return out[..., :hd] if out.shape[-1] != hd else out
