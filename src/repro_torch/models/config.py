"""Model configuration: the port's copy of ``repro.models.config``.

A model is a list of *segments*; each segment is ``reps`` repetitions of a
short static list of layer specs (gemma-3's 5 local : 1 global pattern is
one segment of six specs).  ``repro`` runs a segment as one ``lax.scan``;
the port runs its layers in the same order as a Python loop
(:mod:`repro_torch.models.transformer`).

Layer kinds: 'attn' (attention + dense MLP), 'moe' (attention + MoE MLP),
'mamba2', 'mlstm', 'slstm', 'shared_attn' (zamba2: attention + dense MLP
with one parameter set reused at every invocation).
"""
from __future__ import annotations

import dataclasses
import math

FULL_ATTENTION = -1  # window sentinel: full causal


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                    # attn | moe | mamba2 | mlstm | slstm | shared_attn
    window: int = FULL_ATTENTION  # sliding-window size (attention kinds)


@dataclasses.dataclass(frozen=True)
class Segment:
    reps: int                    # repetitions of the layer list
    layers: tuple[LayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return self.reps * len(self.layers)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: tuple[Segment, ...]
    head_dim: int | None = None
    qkv_bias: bool = False       # qwen-style
    mlp: str = "swiglu"          # swiglu | geglu | gelu
    n_experts: int = 0
    top_k: int = 0
    moe_capacity: float = 1.25
    moe_group: int = 256
    ssm_state: int = 64
    ssm_chunk: int = 128
    ssm_expand: int = 2
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    vocab_pad_to: int = 2048     # padded vocab (repro shards it)
    tie_embeddings: bool = True
    modality: str = "text"
    max_position: int = 131_072
    kv_dtype: str = "bf16"       # KV cache in the compute dtype | "int8"
                                 # (per-(token, kv-head) max-abs codes + scales)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        v = self.vocab
        return v + ((-v) % self.vocab_pad_to)

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)

    def n_params(self) -> int:
        """Exact parameter count, from the port's own shape tree."""
        from repro_torch.models.transformer import tree_shapes

        return int(sum(math.prod(s) for s in _leaves(tree_shapes(self))))

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.n_params()
        dense_frac = self.top_k / self.n_experts
        d = self.d_model
        n_mlp_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        moe_total = sum(seg.reps * sum(1 for sp in seg.layers if sp.kind == "moe")
                        for seg in self.segments)
        inactive = moe_total * (1 - dense_frac) * self.n_experts * n_mlp_mats * d * self.d_ff
        return int(self.n_params() - inactive)


def _leaves(tree):
    if isinstance(tree, tuple):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def uniform_segments(n_layers: int, kind: str = "attn",
                     window: int = FULL_ATTENTION) -> tuple[Segment, ...]:
    return (Segment(reps=n_layers, layers=(LayerSpec(kind, window),)),)


def pattern_segments(n_layers: int, pattern: tuple[LayerSpec, ...]) -> tuple[Segment, ...]:
    if n_layers % len(pattern):
        raise ValueError(f"{n_layers} layers do not repeat a pattern of "
                         f"{len(pattern)}")
    return (Segment(reps=n_layers // len(pattern), layers=pattern),)
