"""Wrapper in the model's layout: (B, T, H, hd) <-> the kernel's (B, H, T, hd).

Port of ``repro/kernels/flash_attention/ops.py``.  The reference picks its
chunk sizes from VMEM (``choose_chunks``) and needs T and S to be multiples
of them; the CUDA kernel's chunks are fixed by its shared memory
(``budget.FLASH_BQ`` x ``budget.FLASH_BK``) and it bounds-tests ragged T
and S, so every row is computed whatever the length.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, H, hd), k/v (B, S, KV, hd) -> (B, T, H, hd).  The
    transposes are views: the kernel reads and writes the model's layout."""
    hd = q.shape[-1]
    sc = scale if scale is not None else hd ** -0.5
    out, _ = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), sc=sc, causal=causal)
    return out.transpose(1, 2)
