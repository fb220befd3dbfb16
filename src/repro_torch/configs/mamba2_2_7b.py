"""Mamba2-2.7B [arXiv:2405.21060; unverified] — SSD (state-space duality),
attention-free.  64L d_model=2560 ssm_state=128 vocab=50280.
Sub-quadratic -> all four shapes including long_500k."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mamba2-2.7b"
FAMILY = "ssm"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=64, d_model=2560, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=4, d_model=64, vocab=512,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
        tie_embeddings=True,
    )
