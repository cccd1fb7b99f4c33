"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig, uniform_segments

SWA_WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
        segments=uniform_segments(56, kind="moe", window=SWA_WINDOW),
        n_experts=8, top_k=2, mlp="swiglu", tie_embeddings=False,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        segments=uniform_segments(2, kind="moe", window=16),
        n_experts=4, top_k=2, mlp="swiglu", tie_embeddings=False,
        vocab_pad_to=64, moe_group=32, moe_capacity=8.0,
    )
