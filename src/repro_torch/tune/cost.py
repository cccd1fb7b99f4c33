"""The autotuner's pruning oracle: a roofline bound for each candidate
(counterpart of ``repro.tune.cost``).

The gathers are bounded as PERF.md §6 bounds them, with the data of the
probe batch (the work depends on it, so the bound counts what this batch
needs), but for the means rows: §6 counts each distinct row of the batch
once, the least any kernel reads, which no tile setting changes; here
they are counted as each setting's tiles stage them:

* bytes: the means-row segments the tiles stage, Σ over tiles of ``bt``
  documents of the tile's distinct live ids, times K × 4 B (a smaller
  tile names fewer documents per row, so it stages more rows); plus the
  tuples, 8 B a slot, and the outputs, 4 B a (document, column) pair per
  plane (sims and counts; esicp's rho12, y, sims and counts);
* operations: 2 · live slots · K, at the fp32 rate;
* the bound: the larger of the two, through
  :func:`repro_torch.roofline.analysis.roofline_terms`.

The columns a slab holds and the grid order move no byte in this count:
those candidates tie on the bound and only timing tells them apart.

On the card the count is a ranking, not a floor: most staged segments
come from L2, not device memory (PERF.md §6: 25 GB staged against 7.3 GB
of distinct rows on a 4096-document NYT batch), so at the NYT widths the
default's estimate is 16.2 ms against the 12.1–12.4 ms it measures
(``chip_smoke.py``'s tune phase, H100 80GB HBM3, 700 W; PERF.md §6).
It ranks the larger tiles first, which is what pruning reads; whether
they are faster only timing tells.

:func:`feasible` is the counterpart of ``repro``'s VMEM gate: the
``(gather, counts, setting)`` instantiation must exist in gather.cu and,
on the card, at least one block of it must fit on an SM.  ``repro``'s
per-grid-step term for its interpreter has no counterpart: nothing here
is interpreted.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.roofline.analysis import HW, roofline_terms
from repro_torch.tune.config import MODES, TILES, TunedConfig, instantiated

#: The kernels a config changes, and the gather each runs.
KERNELS = ("sparse_sim", "esicp_gather")
GATHER = {"sparse_sim": "sims", "esicp_gather": "esicp"}
#: Output planes of 4 B per (document, column) of each, with counts.
OUT_PLANES = {"sparse_sim": 2, "esicp_gather": 4}


@dataclasses.dataclass(frozen=True)
class KernelShape:
    """Logical shape of one gather launch."""
    b: int
    p: int
    d: int
    k: int


@dataclasses.dataclass(frozen=True)
class BatchWork:
    """What a batch's data asks of a gather: its live slots and, per
    documents per tile, Σ over its tiles of their distinct live ids."""
    live: int
    tile_rows: dict


def tile_distinct(ids: torch.Tensor, live: torch.Tensor, d: int,
                  bt: int) -> int:
    """Σ over tiles of ``bt`` consecutive rows of the tile's distinct live
    ids: the row segments a document-tiled gather stages."""
    tile = torch.arange(ids.shape[0], device=ids.device) // bt
    keys = (tile[:, None] * d + ids.long())[live]
    return int(torch.unique(keys).numel())


def batch_work(ids: torch.Tensor, vals: torch.Tensor, d: int) -> BatchWork:
    """The :class:`BatchWork` of a (B, P) batch for every tile of
    :data:`repro_torch.tune.config.TILES`."""
    live = vals != 0
    bts = sorted({bt for tiles in TILES.values() for bt, _ in tiles})
    return BatchWork(live=int(live.sum()),
                     tile_rows={bt: tile_distinct(ids, live, d, bt)
                                for bt in bts})


def feasible(cfg: TunedConfig, *, kernels=KERNELS,
             blocks_per_sm=None) -> bool:
    """Can ``cfg`` launch every kernel of ``kernels`` with counts, as the
    fits do?  ``blocks_per_sm(mode, setting, counts)`` is the library's
    occupancy query on the card (None: not checked)."""
    for kernel in kernels:
        g = GATHER[kernel]
        s = cfg.launch_setting(g)
        if not instantiated(g, True, s):
            return False
        if blocks_per_sm is not None and blocks_per_sm(MODES[g], s, 1) < 1:
            return False
    return True


def kernel_flops_bytes(kernel: str, cfg: TunedConfig, shape: KernelShape,
                       work: BatchWork) -> tuple[float, float]:
    """(operations, bytes) of one launch of ``kernel`` under ``cfg``."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    g = GATHER[kernel]
    bt, _ = TILES[g][getattr(cfg, f"{g}_setting")]
    flops = 2.0 * work.live * shape.k
    nbytes = (work.tile_rows[bt] * shape.k * 4.0 + shape.b * shape.p * 8.0
              + OUT_PLANES[kernel] * shape.b * shape.k * 4.0)
    return flops, nbytes


def lower_bound_seconds(cfg: TunedConfig, shape: KernelShape,
                        work: BatchWork, *, kernels=KERNELS,
                        hw: HW | None = None) -> float:
    """Roofline bound on the summed time of ``kernels`` under ``cfg``."""
    hw = hw or HW()
    total = 0.0
    for kernel in kernels:
        flops, nbytes = kernel_flops_bytes(kernel, cfg, shape, work)
        terms = roofline_terms({"flops": flops, "bytes accessed": nbytes},
                               hw)
        total += max(terms["t_compute_s"], terms["t_memory_s"])
    return total
