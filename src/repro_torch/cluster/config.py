"""Declarative clustering configuration (counterpart of
``repro.cluster.config``), cut to the fields the single-host path reads,
plus ``device``."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.estparams import EstGrid
from repro_torch.core.meanindex import StructuralParams


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """k: number of clusters.  algo: 'mivi', 'icp', 'es', 'esicp',
    'ta-icp', 'cs-icp', 'bounds', 'sketch' or 'bounds-esicp'.  params: 'auto'
    (EstParams at ``est_iters``), a StructuralParams, or None (trivial).
    batch_size: rows per assignment batch.  seed: centroid-seeding seed.
    device: 'cuda' (the default; raises without a GPU) or 'cpu' (the plain
    PyTorch versions of the kernels)."""

    k: int
    algo: str = "esicp"
    params: Any = "auto"
    batch_size: int = 4096
    max_iter: int = 60
    est_grid: EstGrid | None = None
    est_iters: tuple = (1, 2)
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "est_iters", tuple(self.est_iters))

    def replace(self, **changes) -> ClusterConfig:
        return dataclasses.replace(self, **changes)

    def validate(self) -> ClusterConfig:
        """Fail fast on a config the single-host path cannot run."""
        from repro_torch.core.assignment import ALGORITHMS

        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.algo not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algo!r}; "
                             f"one of {sorted(ALGORITHMS)}")
        if not (self.params == "auto" or self.params is None
                or isinstance(self.params, StructuralParams)):
            raise ValueError("params must be 'auto', None, or a "
                             f"StructuralParams; got {self.params!r}")
        if self.batch_size < 1 or self.max_iter < 1:
            raise ValueError("batch_size and max_iter must be >= 1")
        return self
