"""Lowering-mode flags shared by layers.py / transformer.py.

Port of ``repro/models/flags.py``, the flags the port's layers read
(``UNROLL`` belongs to the JAX compile):

  REMAT        -- activation checkpointing of the layer stack: ``none``,
                  ``dots`` (keep the un-batched products' outputs, recompute
                  the rest) or ``full`` (keep only each block's input).
  ATTN_IMPL    -- full-sequence attention: ``chunked`` (PyTorch online
                  softmax) or ``flash`` (the CUDA flash-attention kernel).
  ATTN_CHUNK   -- q/kv chunk size of the chunked attention.
  MOE_CAPACITY -- expert capacity factor: assignments above an expert's
                  capacity are dropped, as in the reference.
  MOE_CONSTRAIN -- kept for the reference's API: there a layout hint
                  that pins the MoE dispatch buffers' expert dim to ``tp``;
                  the port's mesh path (``layers._moe_mesh``) always lays
                  them out so, and reads no flag.
  MOE_IMPL     -- ``gather`` (the dispatch by sort and gathers, on every
                  token of the batch) or ``ep`` (expert parallelism: an
                  all-to-all over the mesh's ``tp`` dim, ``moe_ep.py``).
"""
from __future__ import annotations

REMAT = "none"        # none | dots | full
ATTN_CHUNK = 1024
ATTN_IMPL = "chunked"  # chunked (torch online softmax) | flash (CUDA kernel)
MOE_CAPACITY = 1.25    # expert capacity factor (drops above)
MOE_CONSTRAIN = False  # explicit sharding constraints on MoE dispatch buffers
MOE_IMPL = "gather"    # gather | ep (all-to-all expert parallel)


def set_moe_impl(impl: str) -> None:
    global MOE_IMPL
    assert impl in ("gather", "ep"), impl
    MOE_IMPL = impl


def set_moe_constrain(flag: bool) -> None:
    global MOE_CONSTRAIN
    MOE_CONSTRAIN = bool(flag)


def set_attn_impl(impl: str) -> None:
    global ATTN_IMPL
    assert impl in ("chunked", "flash"), impl
    ATTN_IMPL = impl


def set_moe_capacity(f: float) -> None:
    global MOE_CAPACITY
    MOE_CAPACITY = float(f)


def set_remat(policy: str) -> None:
    global REMAT
    assert policy in ("none", "dots", "full"), policy
    REMAT = policy
