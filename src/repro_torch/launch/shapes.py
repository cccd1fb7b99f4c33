"""Assigned input-shape grid + per-cell eligibility (the port's copy of
``repro.launch.shapes``).

Shapes (identical for all ten LM archs):
    train_4k     seq 4 096   global batch 256   -> train_step
    prefill_32k  seq 32 768  global batch 32    -> prefill_step
    decode_32k   seq 32 768  global batch 128   -> serve (decode) step
    long_500k    seq 524 288 global batch 1     -> serve (decode) step

long_500k needs a sub-quadratic stack: it runs for SSM/hybrid/linear
(xlstm, zamba2), sliding-window (mixtral), and gemma3 (5:1 local pattern;
global layers fall back to a 32k window).  Pure full-attention archs
skip it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs whose stack is sub-quadratic (or windowed) end-to-end at 500k
LONG_OK = {"xlstm-125m", "zamba2-2.7b", "gemma3-1b", "mixtral-8x22b"}

FRONTEND_LEN = {"musicgen-large": 256, "chameleon-34b": 1024}


def cell_enabled(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_OK
    return True


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell of the archs the port runs."""
    from repro_torch.configs.registry import list_archs
    return [(a, s) for a in list_archs() for s in SHAPES]
