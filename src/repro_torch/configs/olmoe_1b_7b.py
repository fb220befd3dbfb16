"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64 experts top-8.
16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "olmoe-1b-7b"
FAMILY = "moe"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # full attn -> no long_500k


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=16, d_model=2048, vocab=50304,
        n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, n_experts=64, top_k=8, moe_d_ff=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=96, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, n_experts=8, top_k=2, moe_d_ff=64,
    )
