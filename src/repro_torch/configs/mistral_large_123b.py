"""Mistral-Large 123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
— dense GQA.  88L d_model=12288 96H (kv=8) d_ff=28672 vocab=32768."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mistral-large-123b"
FAMILY = "dense"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=88, d_model=12288, vocab=32768,
        n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=28672,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=96, vocab=512,
        n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192,
    )
