"""Execution strategies (counterpart of ``repro.cluster.strategies``).

``single_host`` is the resident Lloyd fit (core/lloyd.py:lloyd_fit);
``streaming`` the out-of-core fit over a DocStore
(core/lloyd.py:streaming_fit), selected by a DocStore input or by
``algo_mode='minibatch'``; ``two_level`` the nested IVF fit
(cluster/two_level.py), selected by ``coarse_k``, whose coarse and cell
fits run through the other two (and share the autotuner's cache);
``mesh`` the distributed loop (distributed/kmeans.py:mesh_fit), selected
by ``mesh=``, run by every rank of the mesh.
"""
from __future__ import annotations

import torch

from repro_torch.cluster.config import ClusterConfig
from repro_torch.core.lloyd import LloydResult, lloyd_fit, streaming_fit
from repro_torch.core.meanindex import build_mean_index
from repro_torch.core.update import KMeansState
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


class MeshStrategy:
    """The distributed loop behind the same estimator, run by every rank
    of ``config.mesh`` (a resident corpus or a DocStore; every rank passes
    the whole corpus and takes its rows).

    The shards stay inside: the strategy trims the padding and gathers the
    final state into an ordinary :class:`KMeansState` on every rank, so
    the FittedModel, classify and save/load are runtime-blind.  The gather
    costs one (D, K) matrix on every rank, beside its own column block
    until the fit's state is dropped.  ``keep_trajectory`` gathers each
    iteration's assignment over the object shards."""

    name = "mesh"

    def fit(self, docs, config: ClusterConfig, df=None, seed_rows=None,
            keep_trajectory: bool = False) -> LloydResult:
        from repro_torch.distributed.kmeans import gather_state, mesh_fit

        mesh = config.mesh
        if mesh is None:
            raise ValueError("MeshStrategy needs ClusterConfig(mesh=...)")
        traj = [] if keep_trajectory else None
        state, history, converged, params = mesh_fit(
            docs, config.k, mesh, algo=config.algo, max_iter=config.max_iter,
            obj_chunk=config.chunk_size, seed=config.seed,
            seed_rows=seed_rows, est_iters=config.est_iters,
            est_grid=config.est_grid, df=df,
            checkpoint_dir=config.checkpoint_dir,
            checkpoint_every=config.checkpoint_every, tune=config.tune,
            trajectory=traj)
        iteration, geo = state.iteration, state.geo
        means_t, moving, assign, rho, rho_prev, ub = gather_state(mesh,
                                                                  state)
        del state
        if traj is not None:
            traj = [torch.cat(mesh.all_gather(_padded(a, geo.n_loc, mesh),
                                              over="object"))[:geo.n_docs]
                    .cpu() for a in traj]
        core = KMeansState(index=build_mean_index(means_t, params,
                                                  moving=moving),
                           assign=assign, rho_self=rho,
                           rho_self_prev=rho_prev, iteration=iteration, ub=ub)
        return LloydResult(state=core, assign=assign, history=history,
                           params=params, converged=converged,
                           n_iter=len(history), trajectory=traj)


def _padded(a: torch.Tensor, n_loc: int, mesh) -> torch.Tensor:
    """A rank's real rows padded to its shard's ``n_loc`` rows (every
    shard the same length, for the gather), on its device."""
    out = torch.zeros((n_loc,), dtype=a.dtype, device=mesh.device)
    out[:len(a)] = a.to(mesh.device)
    return out


STRATEGIES = {"single_host": SingleHostStrategy(),
              "streaming": StreamingStrategy(),
              "mesh": MeshStrategy(),
              "two_level": TwoLevelStrategy()}


def resolve_strategy(config: ClusterConfig, docs=None):
    """(ClusterConfig, optional corpus) -> execution strategy.  A DocStore
    input promotes 'single_host' to 'streaming'."""
    config.validate()
    name = config.strategy
    if name == "single_host" and isinstance(docs, DocStore):
        name = "streaming"
    return STRATEGIES[name]
