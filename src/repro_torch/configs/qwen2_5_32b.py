"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig, uniform_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064,
        segments=uniform_segments(64),
        qkv_bias=True, mlp="swiglu", tie_embeddings=False,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=128,
        segments=uniform_segments(2),
        qkv_bias=True, mlp="swiglu", tie_embeddings=False, vocab_pad_to=64,
    )
