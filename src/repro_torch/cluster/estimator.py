"""``SphericalKMeans`` — the sklearn-style estimator (counterpart of
``repro.cluster.estimator``), with ``device=`` in place of ``backend=``.

``fit`` returns ``self`` and sets ``model_`` (the FittedModel artifact),
``labels_``, ``history_``, ``state_``, ``params_``, ``n_iter_``,
``converged_`` and ``objective_``; ``predict``/``transform``/``score``
share the classify path (cluster/classify.py).  A DocStore input routes
the fit through the streaming strategy, and ``mesh=`` (a
:class:`repro_torch.launch.mesh.Mesh`) through the mesh runtime, fitted by
every rank of the mesh.  ``repro``'s deprecation shims of
its pre-redesign surface (``fit_result()``, the forwarded legacy result
attributes) are not ported: the port has no old callers.
"""
from __future__ import annotations

from repro_torch.cluster.config import ClusterConfig
from repro_torch.cluster.model import FittedModel
from repro_torch.cluster.strategies import resolve_strategy
from repro_torch.core.estparams import EstGrid

_FITTED_ATTRS = frozenset({
    "model_", "labels_", "history_", "state_", "params_", "n_iter_",
    "converged_", "objective_",
})


class SphericalKMeans:
    """algo: one of the nine modes; params: 'auto', a StructuralParams or
    None; algo_mode: 'full' or 'minibatch'; device: 'cuda' (default) or
    'cpu'; coarse_k / n_probe: the two-level IVF fit, whose ``model_`` is
    the nested :class:`TwoLevelFittedModel`; tune / tune_budget: the
    gathers' autotuner (``ClusterConfig``), whose winner ``model_``
    carries as ``cuda_tuned``; mesh: a
    :class:`repro_torch.launch.mesh.Mesh`, the same fit on the mesh
    runtime (every rank calls ``fit``; ``model_`` is the whole model on
    every rank)."""

    def __init__(self, k: int, *, algo: str = "esicp", params="auto",
                 device: str = "cuda", batch_size: int = 4096,
                 max_iter: int = 60, est_grid: EstGrid | None = None,
                 est_iters=(1, 2), seed: int = 0, mesh=None,
                 chunk_size: int = 1024, algo_mode: str = "full",
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 5, tune: str = "off",
                 tune_budget=None, coarse_k: int | None = None,
                 n_probe: int = 1):
        self.k = k
        self.algo = algo
        self.params = params
        self.device = device
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.est_grid = est_grid or EstGrid()
        self.est_iters = tuple(est_iters)
        self.seed = seed
        self.mesh = mesh
        self.chunk_size = chunk_size
        self.algo_mode = algo_mode
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.tune = tune
        self.tune_budget = tune_budget
        self.coarse_k = coarse_k
        self.n_probe = n_probe

    @property
    def config(self) -> ClusterConfig:
        """The declarative view of this estimator (rebuilt per access)."""
        return ClusterConfig(
            k=self.k, algo=self.algo, params=self.params,
            batch_size=self.batch_size, chunk_size=self.chunk_size,
            max_iter=self.max_iter, est_grid=self.est_grid,
            est_iters=self.est_iters, seed=self.seed,
            algo_mode=self.algo_mode, checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every, device=self.device,
            mesh=self.mesh, coarse_k=self.coarse_k, n_probe=self.n_probe,
            tune=self.tune, tune_budget=self.tune_budget)

    @classmethod
    def from_config(cls, config: ClusterConfig) -> SphericalKMeans:
        return cls(config.k, algo=config.algo, params=config.params,
                   device=config.device, batch_size=config.batch_size,
                   max_iter=config.max_iter, est_grid=config.est_grid,
                   est_iters=config.est_iters, seed=config.seed,
                   mesh=config.mesh, chunk_size=config.chunk_size,
                   algo_mode=config.algo_mode,
                   checkpoint_dir=config.checkpoint_dir,
                   checkpoint_every=config.checkpoint_every,
                   tune=config.tune, tune_budget=config.tune_budget,
                   coarse_k=config.coarse_k, n_probe=config.n_probe)

    def fit(self, docs, df=None, seed_rows=None, *,
            keep_trajectory: bool = False) -> SphericalKMeans:
        """Cluster resident SparseDocs or a DocStore; returns ``self``.
        ``seed_rows`` names the K seed documents (else drawn from
        ``seed``; a two-level fit takes a callable, see
        ``TwoLevelStrategy``); ``keep_trajectory`` keeps the assignment
        after every iteration in ``model_.trajectory``."""
        cfg = self.config
        strategy = resolve_strategy(cfg, docs)
        res = strategy.fit(docs, cfg, df=df, seed_rows=seed_rows,
                           keep_trajectory=keep_trajectory)
        self.model_ = getattr(res, "model", None) or FittedModel(
            index=res.state.index, labels=res.assign,
            rho_self=res.state.rho_self, history=list(res.history),
            converged=res.converged, n_iter=res.n_iter, algo=cfg.algo,
            strategy=strategy.name, cursor=res.cursor,
            trajectory=res.trajectory,
            cuda_tuned=None if res.tuned is None else res.tuned.to_dict())
        self.labels_ = self.model_.labels
        self.history_ = self.model_.history
        self.state_ = res.state
        self.params_ = res.params
        self.n_iter_ = res.n_iter
        self.converged_ = res.converged
        self.objective_ = res.objective
        return self

    def fit_predict(self, docs, df=None, seed_rows=None):
        return self.fit(docs, df=df, seed_rows=seed_rows).labels_

    def predict(self, docs):
        """(N,) cluster ids vs the fitted index."""
        return self._model().predict(docs, batch_size=self.batch_size)

    def transform(self, docs):
        """(N, K) cosine similarities vs the fitted means."""
        return self._model().transform(docs, batch_size=self.batch_size)

    def score(self, docs) -> float:
        """Σ_i max_j cos(x_i, μ_j) (higher is better)."""
        return self._model().score(docs, batch_size=self.batch_size)

    def _model(self) -> FittedModel:
        if "model_" not in self.__dict__:
            raise AttributeError("This SphericalKMeans instance is not "
                                 "fitted yet; call fit() first.")
        return self.model_

    def __getattr__(self, name):
        if name in _FITTED_ATTRS:
            raise AttributeError(f"SphericalKMeans.{name} is only available "
                                 "after fit(); this instance is not fitted "
                                 "yet.")
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")
