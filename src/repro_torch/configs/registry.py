"""Architecture registry of the port: the archs it can run.

``repro.configs.registry.ARCHS`` lists ten; the port runs the serving
path of the eight attention-family ones (dense, MoE, and the audio and
image stub frontends).  Asking for xlstm-125m or zamba2-2.7b, whose
mamba2/mlstm/slstm/shared_attn layer kinds are not ported, raises
``NotImplementedError`` (ROADMAP.md Queue 1 item 3 lists what is left).
"""
from __future__ import annotations

import importlib

# Every arch of repro's registry, in its order.
REPRO_ARCHS = [
    "mixtral-8x22b",
    "granite-moe-3b-a800m",
    "xlstm-125m",
    "qwen1.5-32b",
    "gemma3-1b",
    "gemma-2b",
    "qwen2.5-32b",
    "zamba2-2.7b",
    "musicgen-large",
    "chameleon-34b",
]
ARCHS = [a for a in REPRO_ARCHS if a not in ("xlstm-125m", "zamba2-2.7b")]


def _module(name: str):
    if name not in REPRO_ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {REPRO_ARCHS}")
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP.md Queue 1 item 3); "
            f"the port runs {ARCHS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)
