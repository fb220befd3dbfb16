"""Yi-9B [arXiv:2403.04652; hf] — llama-arch GQA.
48L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "yi-9b"
FAMILY = "dense"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=48, d_model=4096, vocab=64000,
        n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128,
    )
