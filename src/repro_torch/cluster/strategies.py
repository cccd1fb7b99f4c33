"""Execution strategies (counterpart of ``repro.cluster.strategies``):
this slice ports ``single_host``, the on-device Lloyd fit."""
from __future__ import annotations

from repro_torch.cluster.config import ClusterConfig
from repro_torch.core.lloyd import LloydResult, lloyd_fit


class SingleHostStrategy:
    """The single-device Lloyd fit (core/lloyd.py)."""

    name = "single_host"

    def fit(self, docs, config: ClusterConfig, df=None, seed_rows=None,
            keep_trajectory: bool = False) -> LloydResult:
        return lloyd_fit(
            docs, k=config.k, algo=config.algo, params=config.params,
            batch_size=config.batch_size, max_iter=config.max_iter,
            est_grid=config.est_grid, est_iters=config.est_iters,
            seed=config.seed, seed_rows=seed_rows, df=df,
            device=config.device, keep_trajectory=keep_trajectory)
