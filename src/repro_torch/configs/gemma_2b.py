"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig, uniform_segments


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab=256000,
        segments=uniform_segments(18),
        mlp="geglu", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense",
        d_model=48, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=96, vocab=128,
        segments=uniform_segments(2),
        mlp="geglu", tie_embeddings=True, vocab_pad_to=64,
    )
