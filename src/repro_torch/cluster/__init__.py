"""``repro_torch.cluster`` — the front door (counterpart of
``repro.cluster``)::

    model = repro_torch.cluster.fit(docs, ClusterConfig(k=10_000))
    labels = model.predict(docs)       # == classify_docs(model.index, docs)
"""
from __future__ import annotations

from repro_torch.cluster.classify import classify_docs
from repro_torch.cluster.config import ClusterConfig
from repro_torch.cluster.model import FittedModel
from repro_torch.cluster.strategies import SingleHostStrategy


def fit(docs, config: ClusterConfig, *, df=None, seed_rows=None,
        keep_trajectory: bool = False) -> FittedModel:
    """(docs, ClusterConfig) -> FittedModel, on ``config.device``.

    ``seed_rows`` optionally names the K documents that seed the centroids;
    ``keep_trajectory`` keeps the assignment after every iteration (on the
    host) in ``FittedModel.trajectory``.
    """
    res = SingleHostStrategy().fit(docs, config.validate(), df=df,
                                   seed_rows=seed_rows,
                                   keep_trajectory=keep_trajectory)
    return FittedModel(index=res.state.index, labels=res.assign,
                       rho_self=res.state.rho_self, history=res.history,
                       converged=res.converged, n_iter=res.n_iter,
                       algo=config.algo, trajectory=res.trajectory)


__all__ = ["ClusterConfig", "FittedModel", "SingleHostStrategy",
           "classify_docs", "fit"]
