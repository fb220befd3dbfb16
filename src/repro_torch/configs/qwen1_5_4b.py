"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B] — dense, QKV bias.
40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
NOTE: 20 heads do not divide the 16-way model axis; attention activations
replicate over tp while FFN/vocab shard (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen1.5-4b"
FAMILY = "dense"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=40, d_model=2560, vocab=151936,
        n_heads=20, n_kv_heads=20, head_dim=128,
        d_ff=6912, qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=80, vocab=512,
        n_heads=5, n_kv_heads=5, head_dim=16,
        d_ff=128, qkv_bias=True,
    )
