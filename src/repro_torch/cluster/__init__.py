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


def fit(docs, config: ClusterConfig, *, df=None,
        seed_rows=None) -> FittedModel:
    """(docs, ClusterConfig) -> FittedModel, on ``config.device``.

    ``seed_rows`` optionally names the K documents that seed the centroids.
    """
    res = SingleHostStrategy().fit(docs, config.validate(), df=df,
                                   seed_rows=seed_rows)
    return FittedModel(index=res.state.index, labels=res.assign,
                       rho_self=res.state.rho_self, history=res.history,
                       converged=res.converged, n_iter=res.n_iter,
                       algo=config.algo)


__all__ = ["ClusterConfig", "FittedModel", "SingleHostStrategy",
           "classify_docs", "fit"]
