"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — Mamba+attention 1:7
interleave, MoE 16e top-2.  72L d_model=8192 64H (kv=8) d_ff=24576
vocab=65536.  Hybrid -> sub-quadratic -> long_500k runs."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "jamba-1.5-large-398b"
FAMILY = "hybrid"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=72, d_model=8192, vocab=65536,
        n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, n_experts=16, top_k=2, moe_d_ff=24576, moe_period=2,
        attn_period=8,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=8, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, n_experts=4, top_k=2, moe_d_ff=64, moe_period=2,
        attn_period=4,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    )
