"""Device resolution shared by every entry point."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cpu"``/torch.device -> torch.device.

    A CUDA request with no GPU present raises instead of carrying on on
    the CPU: the CPU runs only when the caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev
