"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens; the EnCodec frontend is a
stub: the caller passes precomputed frame embeddings (B, S_fe, D) as
``frontend_embeds``.
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig, uniform_segments

FRONTEND_FRAMES = 256   # stub conditioning prefix length


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
        segments=uniform_segments(48),
        mlp="gelu", tie_embeddings=False, modality="audio_tokens",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
        segments=uniform_segments(2),
        mlp="gelu", tie_embeddings=False, modality="audio_tokens",
        vocab_pad_to=64,
    )
