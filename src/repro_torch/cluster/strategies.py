"""Execution strategies (counterpart of ``repro.cluster.strategies``).

``single_host`` is the resident Lloyd fit (core/lloyd.py:lloyd_fit);
``streaming`` the out-of-core fit over a DocStore
(core/lloyd.py:streaming_fit), selected by a DocStore input or by
``algo_mode='minibatch'``; ``two_level`` the nested IVF fit
(cluster/two_level.py), selected by ``coarse_k``, whose coarse and cell
fits run through the other two (and share the autotuner's cache).
``mesh`` is not ported yet.
"""
from __future__ import annotations

from repro_torch.cluster.config import NOT_PORTED, ClusterConfig
from repro_torch.core.lloyd import LloydResult, lloyd_fit, streaming_fit
from repro_torch.sparse.store import DocStore, as_store


class SingleHostStrategy:
    """The single-device Lloyd fit over resident documents."""

    name = "single_host"

    def fit(self, docs, config: ClusterConfig, df=None, seed_rows=None,
            keep_trajectory: bool = False) -> LloydResult:
        return lloyd_fit(
            docs, k=config.k, algo=config.algo, params=config.params,
            batch_size=config.batch_size, max_iter=config.max_iter,
            est_grid=config.est_grid, est_iters=config.est_iters,
            seed=config.seed, seed_rows=seed_rows, df=df,
            device=config.device, keep_trajectory=keep_trajectory,
            tune=config.tune, tune_budget=config.tune_budget)


class StreamingStrategy:
    """The chunked fit over a DocStore; resident documents are wrapped as
    an in-memory store of ``config.chunk_size`` rows per chunk."""

    name = "streaming"

    def fit(self, docs, config: ClusterConfig, df=None, seed_rows=None,
            keep_trajectory: bool = False) -> LloydResult:
        return streaming_fit(
            as_store(docs, chunk_size=config.chunk_size), k=config.k,
            algo=config.algo, params=config.params,
            algo_mode=config.algo_mode, batch_size=config.batch_size,
            max_iter=config.max_iter, est_grid=config.est_grid,
            est_iters=config.est_iters, seed=config.seed,
            seed_rows=seed_rows, df=df,
            checkpoint_dir=config.checkpoint_dir,
            checkpoint_every=config.checkpoint_every, device=config.device,
            keep_trajectory=keep_trajectory, tune=config.tune,
            tune_budget=config.tune_budget)


class TwoLevelStrategy:
    """The nested IVF fit: its result carries the nested artifact
    (``model``), which the estimator adopts.  ``seed_rows`` is a callable
    ``seed_rows(n_docs, k, seed=seed)`` for the coarse fit and every cell
    (:func:`repro_torch.cluster.two_level.two_level_fit`)."""

    name = "two_level"

    def fit(self, docs, config: ClusterConfig, df=None, seed_rows=None,
            keep_trajectory: bool = False):
        from repro_torch.cluster.two_level import two_level_fit

        if config.coarse_k is None:
            raise ValueError("TwoLevelStrategy needs ClusterConfig("
                             "coarse_k=...)")
        if seed_rows is not None and not callable(seed_rows):
            raise TypeError("a two-level fit takes seed_rows as a callable "
                            "seed_rows(n_docs, k, seed=seed)")
        if keep_trajectory:
            raise ValueError("a two-level fit keeps no trajectory")
        return two_level_fit(docs, config, df=df, seed_rows=seed_rows)


STRATEGIES = {"single_host": SingleHostStrategy(),
              "streaming": StreamingStrategy(),
              "two_level": TwoLevelStrategy()}


def resolve_strategy(config: ClusterConfig, docs=None):
    """(ClusterConfig, optional corpus) -> execution strategy.  A DocStore
    input promotes 'single_host' to 'streaming'."""
    config.validate()
    name = config.strategy
    if name in NOT_PORTED:
        raise NotImplementedError(f"the {name!r} strategy needs "
                                  f"{NOT_PORTED[name]}")
    if name == "single_host" and isinstance(docs, DocStore):
        name = "streaming"
    return STRATEGIES[name]
