"""Phi-3-Vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf] —
phi3-mini backbone + CLIP frontend (STUB: input_specs() provides precomputed
patch embeddings).  32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"
FAMILY = "vlm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=32, d_model=3072, vocab=32064,
        n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128,
    )
