"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig, uniform_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
        segments=uniform_segments(32, kind="moe"),
        n_experts=40, top_k=8, mlp="swiglu", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="moe",
        d_model=48, n_heads=4, n_kv_heads=2, d_ff=32, vocab=128,
        segments=uniform_segments(2, kind="moe"),
        n_experts=8, top_k=4, mlp="swiglu", tie_embeddings=True,
        vocab_pad_to=64, moe_group=32, moe_capacity=8.0,
    )
