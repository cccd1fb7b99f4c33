"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + one SHARED attention block
invoked every 6 layers (9 superblocks × (5 mamba2 + shared attn)).
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import LayerSpec, ModelConfig, Segment


def _segments(reps: int) -> tuple[Segment, ...]:
    pat = tuple([LayerSpec("mamba2")] * 5 + [LayerSpec("shared_attn")])
    return (Segment(reps=reps, layers=pat),)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        segments=_segments(9),                    # 54 layers
        ssm_state=64, ssm_chunk=128, mlp="gelu", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        segments=(Segment(reps=2, layers=(LayerSpec("mamba2"),
                                          LayerSpec("shared_attn"))),),
        ssm_state=16, ssm_chunk=16, mlp="gelu", tie_embeddings=True,
        vocab_pad_to=64,
    )
