"""``repro_torch.serve`` — the serving plane over fitted clustering
artifacts (counterpart of ``repro.serve``).

  * :class:`ClusterEngine` (engine.py) — classify/refit against a frozen
    MeanIndex, one caller at a time; its ``refit`` streams DocStores chunk
    by chunk and its ``serve()`` lifts the artifact into the service below.
  * :class:`ClusterServer` (server.py) — the continuous-batching classify
    service: per-model request queues and batching threads (batching.py),
    padded batch-size buckets, each replayed from one CUDA graph
    (servable.py), ``max_live_batches`` admission control, one device
    thread decoupled from the post-processing workers, and a
    :class:`ModelRegistry` (registry.py) with load/unload and
    zero-downtime hot-swap after a refit.

The LM surfaces (``ServeLoop``, ``make_prefill_fn``, ``make_decode_fn``)
live in :mod:`repro_torch.serve.lm` and load lazily: importing
``repro_torch.serve`` does not import ``repro_torch.models``.
"""
from repro_torch.serve.batching import ClassifyFuture, ServerClosed
from repro_torch.serve.engine import ClusterEngine
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.servable import ServableClusterModel
from repro_torch.serve.server import ClusterServer

_LM_NAMES = ("make_prefill_fn", "make_decode_fn", "ServeLoop")

__all__ = ["ClassifyFuture", "ClusterEngine", "ClusterServer",
           "ModelRegistry", "ServableClusterModel", "ServerClosed",
           *_LM_NAMES]


def __getattr__(name):
    # The LM surface is imported only when asked for, so the clustering
    # plane never brings repro_torch.models into the process.
    if name in _LM_NAMES:
        import repro_torch.serve.lm as _lm

        return getattr(_lm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
