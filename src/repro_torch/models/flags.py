"""Lowering-mode flags shared by layers.py / transformer.py.

Port of ``repro/models/flags.py``, the two flags the port's attention
reads (``REMAT``, ``UNROLL`` and the MoE flags belong to the JAX compile
and to families the port does not run yet):

  ATTN_IMPL  -- full-sequence attention: ``chunked`` (PyTorch online
                softmax) or ``flash`` (the CUDA flash-attention kernel).
  ATTN_CHUNK -- q/kv chunk size of the chunked attention.
"""
from __future__ import annotations

ATTN_CHUNK = 1024
ATTN_IMPL = "chunked"  # chunked (torch online softmax) | flash (CUDA kernel)


def set_attn_impl(impl: str) -> None:
    global ATTN_IMPL
    assert impl in ("chunked", "flash"), impl
    ATTN_IMPL = impl

