"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion over VQ image tokens; the VQ tokenizer frontend
is a stub: the caller passes precomputed patch embeddings (B, S_fe, D)
as ``frontend_embeds``.
[arXiv:2405.09818; unverified]"""
from repro_torch.models.config import ModelConfig, uniform_segments

FRONTEND_PATCHES = 1024   # stub image-token prefix length


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536,
        segments=uniform_segments(48),
        mlp="swiglu", tie_embeddings=False, modality="image_tokens",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", family="vlm",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        segments=uniform_segments(2),
        mlp="swiglu", tie_embeddings=False, modality="image_tokens",
        vocab_pad_to=64,
    )
