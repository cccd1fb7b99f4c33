"""``repro_torch.cluster`` — the front door (counterpart of
``repro.cluster``)::

    model = repro_torch.cluster.fit(docs, ClusterConfig(k=10_000))
    labels = model.predict(docs)       # == classify_docs(model.index, docs)
    model.save(path); model = load_model(path)
    engine = ClusterEngine.from_model(model)   # serve, refit, hot-swap

``docs`` may be resident SparseDocs or a DocStore (the streaming fit);
``ClusterConfig(mesh=...)`` fits on the mesh runtime (every rank calls
``fit``).
``ClusterConfig(coarse_k=K_c, n_probe=)`` fits the two-level IVF model
(:class:`TwoLevelFittedModel`), whose ``predict`` is
:func:`classify_docs_routed`; :func:`two_level_from_means` wraps given
vectors as its fine level.
"""
from __future__ import annotations

from repro_torch.cluster.classify import (classify_docs,
                                          classify_docs_routed,
                                          transform_docs)
from repro_torch.cluster.config import ClusterConfig
from repro_torch.cluster.estimator import SphericalKMeans
from repro_torch.cluster.model import (FittedModel, TwoLevelFittedModel,
                                       load_model)
from repro_torch.cluster.strategies import (STRATEGIES, MeshStrategy,
                                            SingleHostStrategy,
                                            StreamingStrategy,
                                            TwoLevelStrategy,
                                            resolve_strategy)
from repro_torch.cluster.two_level import two_level_from_means


def fit(docs, config: ClusterConfig, *, df=None, seed_rows=None,
        keep_trajectory: bool = False) -> FittedModel:
    """(docs, ClusterConfig) -> FittedModel (a TwoLevelFittedModel when
    ``coarse_k`` is set), on ``config.device``, through the estimator.
    ``seed_rows`` optionally names the K documents that seed the
    centroids (a two-level fit takes a callable, ``TwoLevelStrategy``);
    ``keep_trajectory`` keeps the assignment after every iteration (on
    the host) in ``FittedModel.trajectory``."""
    return SphericalKMeans.from_config(config).fit(
        docs, df=df, seed_rows=seed_rows,
        keep_trajectory=keep_trajectory).model_


__all__ = ["ClusterConfig", "ClusterEngine", "FittedModel", "MeshStrategy",
           "STRATEGIES", "SingleHostStrategy", "SphericalKMeans",
           "StreamingStrategy", "TwoLevelFittedModel", "TwoLevelStrategy",
           "classify_docs", "classify_docs_routed", "fit", "load_model",
           "resolve_strategy", "transform_docs", "two_level_from_means"]


def __getattr__(name):
    # ClusterEngine lives in repro_torch.serve, whose modules import this
    # package's: re-exported on first use, so neither import order cycles.
    if name == "ClusterEngine":
        from repro_torch.serve.engine import ClusterEngine

        return ClusterEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
