"""Roofline terms of one piece of work on one card (counterpart of
``repro.roofline.analysis``)::

    compute term = operations / peak rate for their type
    memory term  = bytes / device-memory rate

:class:`HW` holds one NVIDIA H100 SXM's data-sheet peaks, which the
autotuner's cost model (:mod:`repro_torch.tune.cost`) and
``chip_smoke.py``'s ``bound_ms`` read: one copy of the numbers.
``repro``'s ``cost_dict``, ``collective_bytes`` and ``model_flops`` read
XLA's compiled artifacts for its dry runs and are not ported yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3 bytes/s,
    fp32 FLOP/s outside the tensor cores, dense TF32 tensor-core FLOP/s.
    A card set below 700 W runs slower under load."""

    hbm_bw: float = 3.35e12
    fp32_flops: float = 67e12
    tf32_flops: float = 495e12


def roofline_terms(cost: dict, hw: HW = HW(), *, rate: float | None = None
                   ) -> dict:
    """Seconds of ``cost`` ({"flops": operations, "bytes accessed":
    bytes}) at ``rate`` (default fp32) and at the memory rate, and which
    bounds it."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / (hw.fp32_flops if rate is None else rate)
    t_memory = nbytes / hw.hbm_bw
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "bottleneck": "memory" if t_memory >= t_compute else "compute"}
