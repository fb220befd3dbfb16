"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias.
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen1.5-0.5b"
FAMILY = "dense"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=24, d_model=1024, vocab=151936,
        n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=2816, qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, qkv_bias=True,
    )
