"""Request queue + continuous batcher for the cluster serving plane
(counterpart of ``repro.serve.batching``).

Thread discipline — per loaded model, ONE batching thread; per server, ONE
device thread and a small post-processing pool:

  batching thread   pulls requests off the model's bounded queue, coalesces
                    them greedily (up to the largest bucket, waiting at most
                    ``batch_timeout_s`` after the first request), snapshots
                    the model's *current* servable ONCE per batch (the
                    hot-swap atomicity point), acquires a live-batch slot
                    (``max_live_batches`` admission control — the thread
                    blocks here while the device is saturated, which is what
                    backpressures the queue), pre-processes on the host, and
                    hands the batch to the device thread;
  device thread     calls ``servable.device_compute``, which enqueues the
                    batch's copy-in, graph replay and copy-out on the
                    servable's stream and returns without a host sync, so
                    it is never the stage that waits for results;
  post workers      wait on each batch's event (the only host syncs in the
                    plane), split the results back per request, resolve
                    the caller futures, and release the live-batch slot.

A batch carries a reference to the exact servable it was assembled against,
so a registry hot-swap mid-flight is invisible: in-flight batches complete
on the pre-swap index while newly assembled batches route to the new one —
no request ever observes a torn index.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np


class ServerClosed(RuntimeError):
    """Raised into futures whose request can no longer be served."""


class ClassifyFuture:
    """Caller-side handle for one submitted classify request.

    A large request may be split across several batches (parts); the future
    resolves when every part has.  ``result`` returns (assign (N,) int32,
    sims (N,) float32) in the request's row order.
    """

    def __init__(self, n_parts: int = 1):
        self._n_parts = n_parts
        self._parts: dict[int, tuple] = {}
        self._exc: BaseException | None = None
        self._event = threading.Event()
        self._lock = threading.Lock()

    def _set_part(self, i: int, assign, sims):
        with self._lock:
            self._parts[i] = (assign, sims)
            if len(self._parts) == self._n_parts and self._exc is None:
                self._event.set()

    def _set_exception(self, exc: BaseException):
        with self._lock:
            if self._exc is None:
                self._exc = exc
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("classify request did not complete in time")
        if self._exc is not None:
            raise self._exc
        parts = [self._parts[i] for i in range(self._n_parts)]
        if self._n_parts == 1:
            return parts[0]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))


class _Request:
    """One batchable unit: <= max bucket rows bound for one future part."""

    __slots__ = ("ids", "vals", "nnz", "n_rows", "future", "part", "t_enq")

    def __init__(self, ids, vals, nnz, future: ClassifyFuture, part: int):
        self.ids, self.vals, self.nnz = ids, vals, nnz
        self.n_rows = int(ids.shape[0])
        self.future = future
        self.part = part
        self.t_enq = time.monotonic()


class _LiveBatch:
    """A batch in flight: the servable it was assembled against + payload."""

    __slots__ = ("batcher", "servable", "prepared", "requests", "out")

    def __init__(self, batcher, servable, prepared, requests):
        self.batcher = batcher
        self.servable = servable
        self.prepared = prepared
        self.requests = requests
        self.out = None


class ServingStats:
    """Lock-protected serving counters (snapshot() for the benchmark)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.n_requests = 0
        self.n_rows = 0
        self.n_failures = 0
        self.n_batches = 0
        self.live_batches = 0
        self.peak_live_batches = 0
        self._buckets: dict[int, list] = {}   # bucket -> [batches, sum_occ]
        self._lat_sum = 0.0

    def batch_started(self, bucket: int, occupancy: float):
        with self._lock:
            self.n_batches += 1
            self.live_batches += 1
            self.peak_live_batches = max(self.peak_live_batches,
                                         self.live_batches)
            b = self._buckets.setdefault(bucket, [0, 0.0])
            b[0] += 1
            b[1] += occupancy

    def batch_finished(self, requests, failed: bool):
        now = time.monotonic()
        with self._lock:
            self.live_batches -= 1
            for r in requests:
                self.n_requests += 1
                self.n_rows += r.n_rows
                self._lat_sum += now - r.t_enq
                if failed:
                    self.n_failures += 1

    def requests_failed(self, requests):
        """Requests that died before their batch was ever recorded live."""
        with self._lock:
            for r in requests:
                self.n_requests += 1
                self.n_rows += r.n_rows
                self.n_failures += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "n_requests": self.n_requests,
                "n_rows": self.n_rows,
                "n_failures": self.n_failures,
                "n_batches": self.n_batches,
                "live_batches": self.live_batches,
                "peak_live_batches": self.peak_live_batches,
                "mean_server_latency_ms": (
                    1e3 * self._lat_sum / self.n_requests
                    if self.n_requests else 0.0),
                "occupancy": {
                    str(b): {"batches": n, "mean_occupancy": s / n}
                    for b, (n, s) in sorted(self._buckets.items())},
            }


_STOP = object()


class ContinuousBatcher:
    """Per-model request queue + batching thread (see module docstring).

    get_servable:     zero-arg callable returning the model's CURRENT
                      servable (the registry's atomic read) — called once
                      per assembled batch.
    dispatch:         callable(_LiveBatch) handing the pre-processed batch
                      to the server's device thread.
    max_live_batches: admission control — at most this many batches between
                      slot-acquire (batch assembly) and slot-release (post
                      processing done).
    queue_depth:      bounded request queue; a full queue blocks (or, with
                      ``submit(block=False)``, rejects) new admissions.
    """

    def __init__(self, name: str, get_servable, dispatch, *,
                 max_live_batches: int = 4, batch_timeout_s: float = 0.002,
                 queue_depth: int = 1024):
        if max_live_batches < 1:
            raise ValueError(f"max_live_batches must be >= 1, "
                             f"got {max_live_batches}")
        self.name = name
        self.get_servable = get_servable
        self.dispatch = dispatch
        self.batch_timeout_s = float(batch_timeout_s)
        self.queue = queue.Queue(maxsize=queue_depth)
        self.slots = threading.Semaphore(max_live_batches)
        self.max_live_batches = max_live_batches
        self.stats = ServingStats()
        self._carry: _Request | None = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"batcher:{name}")
        self._thread.start()

    # -- admission ----------------------------------------------------------
    def submit(self, request: _Request, *, block: bool = True,
               timeout: float | None = None):
        if self._stopped.is_set():
            raise ServerClosed(f"model {self.name!r} is no longer served")
        try:
            self.queue.put(request, block=block, timeout=timeout)
        except queue.Full:
            raise ServerClosed(
                f"model {self.name!r}: request queue full "
                f"({self.queue.maxsize} pending) — the server is "
                f"backpressuring; retry or raise queue_depth") from None

    # -- batch assembly -----------------------------------------------------
    def _next_request(self, deadline: float | None):
        if self._carry is not None:
            r, self._carry = self._carry, None
            return r
        try:
            if deadline is None:
                return self.queue.get(timeout=0.05)
            left = deadline - time.monotonic()
            if left <= 0:
                return self.queue.get_nowait()
            return self.queue.get(timeout=left)
        except queue.Empty:
            return None

    def _run(self):
        while not self._stopped.is_set():
            first = self._next_request(None)
            if first is None:
                continue
            if first is _STOP:
                break
            servable = self.get_servable()     # hot-swap atomicity point
            max_rows = servable.max_batch_size
            reqs, rows = [first], first.n_rows
            deadline = time.monotonic() + self.batch_timeout_s
            while rows < max_rows:
                nxt = self._next_request(deadline)
                if nxt is None:
                    break
                if nxt is _STOP:
                    self._stopped.set()
                    break
                if rows + nxt.n_rows > max_rows:
                    self._carry = nxt          # head-of-line for next batch
                    break
                reqs.append(nxt)
                rows += nxt.n_rows
            self.slots.acquire()               # max_live_batches admission
            try:
                prepared = servable.pre_process(
                    [(r.ids, r.vals, r.nnz) for r in reqs])
                self.stats.batch_started(prepared.bucket, prepared.occupancy)
                self.dispatch(_LiveBatch(self, servable, prepared, reqs))
            except BaseException as e:
                self.fail_batch(reqs, e, started=False)
        self._drain()

    # -- completion paths (called from the post workers / device thread) ----
    def finish_batch(self, live: _LiveBatch):
        try:
            a, s = live.servable.post_process(live.out, live.prepared.n_rows)
            off = 0
            for r in live.requests:
                r.future._set_part(r.part, a[off:off + r.n_rows],
                                   s[off:off + r.n_rows])
                off += r.n_rows
            self.stats.batch_finished(live.requests, failed=False)
        except BaseException as e:
            for r in live.requests:
                r.future._set_exception(e)
            self.stats.batch_finished(live.requests, failed=True)
        finally:
            self.slots.release()

    def fail_batch(self, requests, exc: BaseException, *,
                   started: bool = True):
        """Fail every request of a batch; ``started`` says whether the batch
        was already recorded live (post-assembly failure) or died during
        pre-processing (never counted a live slot in the stats)."""
        for r in requests:
            r.future._set_exception(exc)
        if started:
            self.stats.batch_finished(requests, failed=True)
        else:
            self.stats.requests_failed(requests)
        self.slots.release()

    # -- shutdown -----------------------------------------------------------
    def _drain(self):
        """Fail whatever is still queued once the batcher stops."""
        leftovers = [] if self._carry is None else [self._carry]
        self._carry = None
        while True:
            try:
                r = self.queue.get_nowait()
            except queue.Empty:
                break
            if r is not _STOP:
                leftovers.append(r)
        exc = ServerClosed(f"model {self.name!r} unloaded before the "
                           f"request was batched")
        for r in leftovers:
            r.future._set_exception(exc)

    def stop(self):
        """Stop assembling batches (in-flight batches still complete)."""
        self._stopped.set()
        self.queue.put(_STOP)
        self._thread.join()
        self._drain()
