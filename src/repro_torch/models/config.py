"""Unified model configuration (copy of ``repro/models/config.py``).

One dataclass describes dense / MoE / hybrid(SSM+attn) / pure-SSM /
encoder-only / VLM-backbone transformers.  Family-specific fields are simply
unused by families that don't need them.  ``repro_torch/configs/<arch>.py``
instantiates these with the exact published sizes plus a reduced smoke config.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.types import DENSE, SparsityConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0                 # 0 => attention-free (pure SSM)
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    # --- MLA (DeepSeek multi-head latent attention) ---
    use_mla: bool = False
    q_lora_rank: int = 0             # 0 => no query compression
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- FFN ---
    d_ff: int = 0
    mlp_act: str = "swiglu"          # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0               # 0 => dense FFN everywhere
    top_k: int = 0
    moe_d_ff: int = 0                # expert intermediate size
    n_shared_experts: int = 0
    moe_period: int = 1              # MoE every k-th layer (jamba: 2)
    first_dense_layers: int = 0      # leading dense layers (deepseek: 3)
    # --- SSM / Mamba2 ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0             # hybrid: 1 attention layer per period (jamba: 8)
    # --- multi-token prediction (deepseek) ---
    mtp_depth: int = 0
    # --- sparsity (the paper's technique, applied to the weights) ---
    sparsity: SparsityConfig = DENSE
    # --- misc ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ----- derived -----
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind ('attn' | 'ssm') for the stack."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.family == "hybrid":
            # 1 attention layer per ``attn_period`` (jamba: index 4 of each
            # 8-layer block holds the attention layer; we use last-of-period).
            return tuple(
                "attn" if (i % self.attn_period) == self.attn_period - 1 else "ssm"
                for i in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    def layer_has_moe(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return (i % self.moe_period) == 0 if self.moe_period > 1 else True

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + stack), for rooflines."""
        p = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.layer_kinds()[i]
            if kind == "attn":
                if self.use_mla:
                    qd = self.q_lora_rank or self.d_model
                    p += self.d_model * self.q_lora_rank if self.q_lora_rank else 0
                    p += qd * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    p += self.d_model * (self.kv_lora_rank + self.qk_rope_head_dim)
                    p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    p += self.n_heads * self.v_head_dim * self.d_model
                else:
                    hd = self.head_dim or self.d_model // self.n_heads
                    p += self.d_model * hd * (self.n_heads + 2 * self.n_kv_heads)
                    p += self.n_heads * hd * self.d_model
            else:
                di, ns = self.d_inner, self.ssm_state
                nh = self.n_ssm_heads
                p += self.d_model * (2 * di + 2 * ns + nh)  # in_proj(z,x) + B,C + dt
                p += di * self.ssm_conv_width + 2 * nh      # conv + A,D
                p += di * self.d_model                      # out_proj
            if self.layer_has_moe(i):
                e, dff = self.n_experts, self.moe_d_ff or self.d_ff
                p += self.d_model * e                       # router
                p += e * 3 * self.d_model * dff
                p += self.n_shared_experts * 3 * self.d_model * dff
            elif kind == "attn" or self.family in ("hybrid",):
                if self.d_ff:
                    mult = 3 if self.mlp_act == "swiglu" else 2
                    p += mult * self.d_model * self.d_ff
            p += 2 * self.d_model                           # norms
        return p

    def active_params(self) -> int:
        """Params touched per token (MoE: only top-k experts) — for 6*N*D."""
        if self.n_experts == 0:
            return self.num_params()
        p = self.num_params()
        # subtract inactive expert params
        dff = self.moe_d_ff or self.d_ff
        n_moe_layers = sum(self.layer_has_moe(i) for i in range(self.n_layers))
        inactive = n_moe_layers * (self.n_experts - self.top_k) * 3 * self.d_model * dff
        return p - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-arch shapes)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
