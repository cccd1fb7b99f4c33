"""Architecture registry of the port: the ten archs of
``repro.configs.registry.ARCHS``, in its order, all of which the port
serves (dense, MoE, the audio and image stub frontends, the xLSTM and the
Mamba2 hybrid with its shared attention block).
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
ARCHS = list(REPRO_ARCHS)


def _module(name: str):
    if name not in REPRO_ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {REPRO_ARCHS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)
