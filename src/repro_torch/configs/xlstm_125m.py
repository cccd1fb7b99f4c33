"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks (xLSTM[5:1]-style interleave: one sLSTM per 6 layers).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import LayerSpec, ModelConfig, Segment


def _segments(reps: int) -> tuple[Segment, ...]:
    pattern = tuple([LayerSpec("mlstm")] * 5 + [LayerSpec("slstm")])
    return (Segment(reps=reps, layers=pattern),)


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        d_model=768, n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        segments=_segments(2),                    # 12 layers
        tie_embeddings=True, ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=128,
        segments=(Segment(reps=1, layers=(LayerSpec("mlstm"), LayerSpec("slstm"))),),
        tie_embeddings=True, vocab_pad_to=64, ssm_chunk=16,
    )
