"""ClusterServer: the continuous-batching classify service front door
(counterpart of ``repro.serve.server``).

One server hosts any number of FittedModels on one device:

    server = ClusterServer(max_live_batches=4)       # device="cuda"
    server.load("news", model)                       # FittedModel artifact
    fut = server.submit("news", docs)                # non-blocking future
    assign, sims = fut.result()                      #   … or …
    assign, sims = server.classify("news", docs)     # synchronous helper
    server.swap("news", engine.to_model())           # zero-downtime refresh
    server.close()

Threads: one batching thread per model (batching.ContinuousBatcher), one
shared device thread (it enqueues each batch's copies and graph replay on
the servable's stream, never a host sync), and a small post-processing
pool (the only threads that wait on the device).  ``submit`` splits
requests larger than the servable's biggest bucket into parts of one
future.  Results equal ``ClusterEngine.classify`` on the same docs bit for
bit: the device stage runs the same fused classify
(cluster/classify.py) against the same index.  ``load`` and ``swap`` build
the servable, and so capture its CUDA graphs, before it takes traffic.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch._device import resolve_device

from repro_torch.serve.batching import (ClassifyFuture, ContinuousBatcher,
                                  ServerClosed, _Request)
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.servable import DEFAULT_BATCH_SIZES, ServableClusterModel

_STOP = object()


def _coerce_rows(docs):
    """SparseDocs | (ids, vals, nnz) triple → numpy (ids, vals, nnz)."""
    if isinstance(docs, tuple) and len(docs) == 3:
        ids, vals, nnz = docs
    else:
        ids, vals, nnz = docs.ids, docs.vals, docs.nnz
    ids = np.asarray(ids, np.int32)
    vals = np.asarray(vals, np.float32)
    nnz = np.asarray(nnz, np.int32)
    if ids.ndim != 2 or ids.shape != vals.shape or nnz.shape != ids.shape[:1]:
        raise ValueError("classify request needs ids/vals (N, P) and nnz (N,)")
    return ids, vals, nnz


class ClusterServer:
    """Continuous-batching classify service over FittedModel artifacts.

    max_live_batches: per-model admission control — batches between
                      assembly and post-processing completion.
    batch_timeout_s:  how long a batching thread waits for more requests
                      after the first before launching a partial batch.
    queue_depth:      per-model bounded request queue (backpressure).
    n_post_workers:   host-sync worker threads shared by all models.
    device:           where every hosted model serves: ``"cuda"`` (default;
                      raises without a GPU) or ``"cpu"`` (the plain
                      versions, eagerly).
    """

    def __init__(self, *, max_live_batches: int = 4,
                 batch_timeout_s: float = 0.002, queue_depth: int = 1024,
                 n_post_workers: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.registry = ModelRegistry()
        self._batcher_kw = dict(max_live_batches=max_live_batches,
                                batch_timeout_s=batch_timeout_s,
                                queue_depth=queue_depth)
        self._batchers: dict[str, ContinuousBatcher] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._device_q: queue.Queue = queue.Queue()
        self._post_q: queue.Queue = queue.Queue()
        self._device_thread = threading.Thread(
            target=self._device_loop, daemon=True, name="serve:device")
        self._device_thread.start()
        self._post_threads = [
            threading.Thread(target=self._post_loop, daemon=True,
                             name=f"serve:post{i}")
            for i in range(max(1, n_post_workers))]
        for t in self._post_threads:
            t.start()

    # -- device / post loops ------------------------------------------------
    def _device_loop(self):
        while True:
            live = self._device_q.get()
            if live is _STOP:
                break
            try:
                # Enqueued on the servable's stream; the post workers pay
                # the host sync.
                live.out = live.servable.device_compute(live.prepared)
            except BaseException as e:
                live.batcher.fail_batch(live.requests, e)
                continue
            self._post_q.put(live)

    def _post_loop(self):
        while True:
            live = self._post_q.get()
            if live is _STOP:
                break
            live.batcher.finish_batch(live)

    # -- model lifecycle ----------------------------------------------------
    def _servable(self, model, batch_sizes, pad_width):
        if isinstance(model, ServableClusterModel):
            return model
        return ServableClusterModel(model, batch_sizes=batch_sizes,
                                    pad_width=pad_width, device=self.device)

    def load(self, name: str, model, *, batch_sizes=DEFAULT_BATCH_SIZES,
             pad_width: int | None = None):
        """Admit a FittedModel (or prebuilt servable) under ``name`` and
        start batching traffic for it.  With ``pad_width`` given, the
        servable's graphs are captured here, before any request."""
        with self._lock:
            if self._closed:
                raise ServerClosed("server is closed")
            servable = self._servable(model, batch_sizes, pad_width)
            self.registry.load(name, servable)
            self._batchers[name] = ContinuousBatcher(
                name, lambda: self.registry.get(name), self._device_q.put,
                **self._batcher_kw)
            return servable

    def unload(self, name: str):
        """Retire ``name``: stop batching (queued-but-unbatched requests
        fail with ServerClosed; in-flight batches complete), drop the
        servable.  Returns the retired servable."""
        with self._lock:
            batcher = self._batchers.pop(name, None)
        if batcher is None:
            raise self.registry._missing(name)
        batcher.stop()
        return self.registry.unload(name)

    def swap(self, name: str, model, *, batch_sizes=DEFAULT_BATCH_SIZES,
             pad_width: int | None = None):
        """Zero-downtime hot-swap: the new servable is built, its graphs
        captured, and then new batches for ``name`` route to it atomically;
        in-flight batches finish on the old servable's graphs; no request
        fails.  Returns the previous servable."""
        with self._lock:
            if self._closed:
                raise ServerClosed("server is closed")
            old = self.registry.get(name)
        if pad_width is None:
            # Inherit the locked width so the new graphs take the same
            # requests as the old ones.
            pad_width = old.pad_width
        servable = self._servable(model, batch_sizes, pad_width)
        with self._lock:
            if self._closed:
                raise ServerClosed("server is closed")
            return self.registry.swap(name, servable)

    # -- request path -------------------------------------------------------
    def submit(self, name: str, docs, *, block: bool = True,
               timeout: float | None = None) -> ClassifyFuture:
        """Enqueue a classify request; returns a :class:`ClassifyFuture`
        resolving to (assign (N,) int32, sims (N,) float32).  Requests
        larger than the model's biggest bucket are split into parts of one
        future.  ``block=False`` raises :class:`ServerClosed` instead of
        waiting when the queue is full (admission backpressure)."""
        with self._lock:
            batcher = self._batchers.get(name)
        if batcher is None:
            raise self.registry._missing(name)
        servable = self.registry.get(name)
        ids, vals, nnz = _coerce_rows(docs)
        n = ids.shape[0]
        if n == 0:
            raise ValueError("classify request needs at least one row")
        cap = servable.max_batch_size
        bounds = list(range(0, n, cap)) + [n]
        future = ClassifyFuture(n_parts=len(bounds) - 1)
        for part, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            batcher.submit(_Request(ids[lo:hi], vals[lo:hi], nnz[lo:hi],
                                    future, part),
                           block=block, timeout=timeout)
        return future

    def classify(self, name: str, docs, *, timeout: float | None = None):
        """Synchronous submit + wait."""
        return self.submit(name, docs).result(timeout)

    # -- introspection ------------------------------------------------------
    def stats(self, name: str) -> dict:
        """Batcher counters + occupancy histogram + per-bucket capture and
        replay counts for one hosted model."""
        with self._lock:
            batcher = self._batchers.get(name)
        if batcher is None:
            raise self.registry._missing(name)
        servable = self.registry.get(name)
        out = batcher.stats.snapshot()
        out["max_live_batches"] = batcher.max_live_batches
        out["buckets"] = list(servable.sorted_batch_sizes)
        out["capture_counts"] = {str(b): c for b, c
                                 in servable.capture_counts().items()}
        out["replay_counts"] = {str(b): c for b, c
                                in servable.replay_counts().items()}
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Stop batching, let in-flight batches complete, join threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop()
        self._device_q.put(_STOP)
        self._device_thread.join()
        for _ in self._post_threads:
            self._post_q.put(_STOP)
        for t in self._post_threads:
            t.join()

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
