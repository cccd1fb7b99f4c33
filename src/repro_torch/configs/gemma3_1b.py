"""gemma3-1b [dense] — 26L d_model=1152 4H (MQA kv=1, head_dim=256)
d_ff=6912 vocab=262144, 5:1 local:global sliding-window pattern, 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]

26 layers = 4 × (5 local + 1 global) + 2 trailing local.
"""
from repro_torch.models.config import (FULL_ATTENTION, LayerSpec, ModelConfig,
                                       Segment)

LOCAL_WINDOW = 512


def _segments(local: int, full: int) -> tuple[Segment, ...]:
    pat = tuple([LayerSpec("attn", window=local)] * 5 +
                [LayerSpec("attn", window=full)])
    return (
        Segment(reps=4, layers=pat),
        Segment(reps=1, layers=(LayerSpec("attn", window=local),
                                LayerSpec("attn", window=local))),
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144,
        segments=_segments(LOCAL_WINDOW, FULL_ATTENTION),
        mlp="geglu", tie_embeddings=True, rope_theta=1e6,
        max_position=131_072,
    )


def long_context_config() -> ModelConfig:
    """long_500k variant: global layers fall back to a 32k window so the
    whole stack stays sub-quadratic."""
    return ModelConfig(
        name="gemma3-1b-long", family="dense",
        d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144,
        segments=_segments(LOCAL_WINDOW, 32_768),
        mlp="geglu", tie_embeddings=True, rope_theta=1e6,
        max_position=600_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        d_model=48, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=96, vocab=128,
        segments=(Segment(reps=1, layers=(LayerSpec("attn", window=8),
                                          LayerSpec("attn", window=FULL_ATTENTION))),),
        mlp="geglu", tie_embeddings=True, vocab_pad_to=64,
    )
