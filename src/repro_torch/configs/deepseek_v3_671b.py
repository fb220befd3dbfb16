"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed
top-8 experts, MTP.  61L d_model=7168 128H d_ff(expert)=2048 vocab=129280."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "deepseek-v3-671b"
FAMILY = "moe"
# full attention (MLA is O(T^2)) -> long_500k skipped (DESIGN.md skip table)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family=FAMILY,
        n_layers=61, d_model=7168, vocab=129280,
        n_heads=128, n_kv_heads=128, head_dim=128,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
        d_ff=18432,                      # dense FFN in the 3 leading layers
        n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
        first_dense_layers=3, mtp_depth=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family=FAMILY,
        n_layers=4, d_model=128, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=32,
        use_mla=True, q_lora_rank=64, kv_lora_rank=32,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        d_ff=256, n_experts=8, top_k=2, moe_d_ff=64, n_shared_experts=1,
        first_dense_layers=1, mtp_depth=1,
    )
