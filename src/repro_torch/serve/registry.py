"""Model registry: several FittedModels hosted on one device, hot-swappable
(counterpart of ``repro.serve.registry``).

A name → :class:`~repro_torch.serve.servable.ServableClusterModel` map
with

  * ``load`` / ``unload`` — admit / retire a model;
  * ``get`` — the batching thread's per-batch snapshot read;
  * ``swap`` — **zero-downtime hot-swap**: atomically replace the servable
    behind a name (e.g. after ``ClusterEngine.refit`` produced a rebuilt
    index).  The replacement is one reference assignment under the registry
    lock, so a reader sees either the old servable or the new one, never a
    torn mix; batches already assembled keep their reference to the old
    servable and complete against the pre-swap index (batching.py).

A servable captures its CUDA graphs when it is built, so the servable a
swap publishes is ready: no request waits on a capture.
"""
from __future__ import annotations

import threading

from repro_torch.serve.servable import ServableClusterModel


class ModelRegistry:
    """Thread-safe name → servable map with atomic replacement."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: dict[str, ServableClusterModel] = {}

    def _missing(self, name: str) -> KeyError:
        return KeyError(f"no model {name!r} is loaded; "
                        f"serving: {sorted(self._models) or '(none)'}")

    def load(self, name: str, servable: ServableClusterModel):
        with self._lock:
            if name in self._models:
                raise ValueError(f"model {name!r} is already loaded; use "
                                 f"swap() to replace it atomically")
            self._models[name] = servable

    def unload(self, name: str) -> ServableClusterModel:
        with self._lock:
            if name not in self._models:
                raise self._missing(name)
            return self._models.pop(name)

    def get(self, name: str) -> ServableClusterModel:
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise self._missing(name) from None

    def swap(self, name: str,
             servable: ServableClusterModel) -> ServableClusterModel:
        """Atomically route new batches for ``name`` to ``servable``;
        returns the previous servable (still referenced by any in-flight
        batches, which finish against it)."""
        with self._lock:
            if name not in self._models:
                raise self._missing(name)
            old, self._models[name] = self._models[name], servable
            return old

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models
