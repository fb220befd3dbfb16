"""HuBERT-XLarge [arXiv:2106.07447; unverified] — encoder-only audio
transformer (w2v2 arch).  48L d_model=1280 16H d_ff=5120 vocab=504.
Modality frontend (conv feature extractor) is a STUB: input_specs() provides
precomputed frame embeddings.  Encoder-only -> no decode shapes."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "hubert-xlarge"
FAMILY = "encoder"
SHAPES = ("train_4k", "prefill_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=48, d_model=1280, vocab=504,
        n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, mlp_act="gelu", causal=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=3, d_model=64, vocab=64,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, mlp_act="gelu", causal=False,
    )
