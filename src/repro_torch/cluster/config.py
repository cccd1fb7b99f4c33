"""Declarative clustering configuration (counterpart of
``repro.cluster.config``), with ``device`` in place of ``backend``."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.estparams import EstGrid
from repro_torch.core.meanindex import StructuralParams


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """k: number of clusters.  algo: 'mivi', 'icp', 'es', 'esicp',
    'ta-icp', 'cs-icp', 'bounds', 'sketch' or 'bounds-esicp'.  algo_mode:
    'full' (exact Lloyd) or 'minibatch' (Sculley-style updates over store
    chunks, always on the 'streaming' strategy).  params: 'auto' (EstParams
    at ``est_iters``), a StructuralParams, or None (trivial).  batch_size:
    rows per assignment batch.  chunk_size: store chunk rows when the
    streaming strategy wraps resident documents.  seed: centroid-seeding
    seed.  checkpoint_dir / checkpoint_every: the streaming fit's resumable
    snapshots, every N chunks inside an epoch and at every epoch boundary.
    device: 'cuda' (the default; raises without a GPU) or 'cpu' (the plain
    PyTorch versions of the kernels).  coarse_k: None (a flat fit) or
    2 <= K_c < k, the two-level IVF fit (K_c coarse cells, then a fine fit
    per cell; the 'two_level' strategy).  n_probe: the cells the routed
    classify scores per document, 1 <= n_probe <= coarse_k (coarse_k
    probes every cell: the flat classify).  tune: 'off' (the gathers'
    default tiles) | 'cached' (a winner found before for this corpus
    regime, else the defaults) | 'search' (the roofline-pruned autotuner
    on a miss, its winner cached; repro_torch.tune); a no-op on the CPU.
    tune_budget: a repro_torch.tune.SearchBudget (or int max timed) for
    'search'.  mesh: a :class:`repro_torch.launch.mesh.Mesh` — the same
    fit on the mesh runtime (the 'mesh' strategy, one of
    ``MESH_ALGOS``; K divisible by the model axis; ``chunk_size`` is its
    per-rank object chunk; ``device`` must name the mesh's device type);
    neither 'minibatch' nor ``coarse_k`` combines with it, as in
    ``repro``."""

    k: int
    algo: str = "esicp"
    params: Any = "auto"
    batch_size: int = 4096
    chunk_size: int = 1024
    max_iter: int = 60
    est_grid: EstGrid | None = None
    est_iters: tuple = (1, 2)
    seed: int = 0
    algo_mode: str = "full"
    checkpoint_dir: str | None = None
    checkpoint_every: int = 5
    device: str = "cuda"
    mesh: Any = None
    coarse_k: int | None = None
    n_probe: int = 1
    tune: str = "off"
    tune_budget: Any = None

    def __post_init__(self):
        object.__setattr__(self, "est_iters", tuple(self.est_iters))

    @property
    def strategy(self) -> str:
        """The execution strategy's name.  A DocStore input also promotes
        'single_host' to 'streaming' (``resolve_strategy``)."""
        if self.coarse_k is not None:
            return "two_level"
        if self.mesh is not None:
            return "mesh"
        return "streaming" if self.algo_mode == "minibatch" else "single_host"

    def replace(self, **changes) -> ClusterConfig:
        return dataclasses.replace(self, **changes)

    def validate(self) -> ClusterConfig:
        """Fail fast on a config no strategy can run.  Returns self."""
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
        if self.batch_size < 1 or self.chunk_size < 1 or self.max_iter < 1:
            raise ValueError("batch_size, chunk_size and max_iter must be "
                             ">= 1")
        if self.algo_mode not in ("full", "minibatch"):
            raise ValueError(f"algo_mode must be 'full' or 'minibatch', "
                             f"got {self.algo_mode!r}")
        if self.tune not in ("off", "cached", "search"):
            raise ValueError(f"tune must be 'off', 'cached' or 'search', "
                             f"got {self.tune!r}")
        if self.coarse_k is not None:
            if self.coarse_k < 2:
                raise ValueError(
                    f"coarse_k must be >= 2 (a one-cell coarse level is the "
                    f"flat fit; pass coarse_k=None for that), got "
                    f"{self.coarse_k}")
            if self.coarse_k >= self.k:
                raise ValueError(
                    f"coarse_k must be < k (each coarse cell holds at least "
                    f"one fine cluster), got coarse_k={self.coarse_k} >= "
                    f"k={self.k}")
            if self.mesh is not None:
                raise ValueError(
                    "coarse_k (the two-level strategy) cannot be combined "
                    "with mesh= yet; run the coarse/fine fits single-host "
                    "or streaming")
        if not 1 <= self.n_probe <= (self.coarse_k or self.n_probe):
            raise ValueError(
                f"n_probe must be in [1, coarse_k={self.coarse_k}], got "
                f"{self.n_probe}")
        if self.algo_mode == "minibatch" and self.mesh is not None:
            raise ValueError(
                "algo_mode='minibatch' runs on the streaming strategy; "
                "it cannot be combined with mesh=")
        if self.mesh is not None:
            from repro_torch.distributed.kmeans import MESH_ALGOS

            if self.algo not in MESH_ALGOS:
                raise ValueError(
                    f"algo {self.algo!r} is not available on the mesh "
                    f"strategy; one of {MESH_ALGOS}")
            n_model = dict(self.mesh.shape).get("model", 1)
            if self.k % n_model:
                raise ValueError(
                    f"K={self.k} must divide over the mesh's model axis "
                    f"({n_model})")
            dev = getattr(self.mesh, "device", None)
            if dev is not None and dev.type != torch.device(self.device).type:
                raise ValueError(
                    f"device={self.device!r} but the mesh's ranks run on "
                    f"{dev.type}")
        return self
