"""ServableClusterModel: a FittedModel prepared for continuous batching
(counterpart of ``repro.serve.servable``).

A servable owns the three stages a request batch moves through —

  * ``pre_process``  — host-side: coalesce request rows, fit them to the
    servable's static tuple width, pick a padded batch-size *bucket* from
    ``sorted_batch_sizes`` (``get_padded_batch_size``) and pad with dead
    rows, so every launch hits a shape whose graph is already captured;
  * ``device_compute`` — the fused classify of the batch
    (:func:`repro_torch.cluster.classify._classify_fused`, the one behind
    ``classify_docs``, so served results equal the direct path bit for
    bit; for a two-level model probing fewer than all K_c cells its routed
    twin ``_routed_fused``, the one behind ``classify_docs_routed``, top-n
    cell selection and ``routed_scan`` kernel included).  On the card it copies the batch into the bucket's static input
    tensors, replays the bucket's CUDA graph and copies the outputs out to
    pinned host buffers, all on the servable's one stream, records an
    event and returns without a host sync; on the CPU it runs the same
    function eagerly with the plain versions;
  * ``post_process`` — host-side: wait on the batch's event, trim the
    dead-row padding.

Capture discipline: ``repro`` compiles once per (backend, dim, K, bucket);
here each servable captures one CUDA graph per bucket, all of them when
the servable is built (or, when no ``pad_width`` was given, when the first
batch locks it), after a warm-up call that builds and loads the kernel
library.  A hot-swap builds the new servable, and so captures its graphs,
before it is published.  ``capture_counts()`` stays at 1 per bucket; the
graph replays are counted per bucket in ``replay_counts()`` (a replay does
not pass through ``kernels.ops``, so ``ops.LAUNCHES`` does not see it).

Two batches of one bucket share its static tensors.  That is safe because
every batch's copy-in, replay and copy-out are enqueued in order on the
one stream (under a lock), and a batch's pinned staging buffers go back to
the pool only after ``post_process`` has waited on its event.  A capture
runs on the servable's stream with ``capture_error_mode="thread_local"``,
so traffic on other threads (another model, or the old servable of a
swap) goes on meanwhile.  A capture that fails raises: there is no eager
fallback on the card.
"""
from __future__ import annotations

import bisect
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cluster.classify import _classify_fused, _routed_fused
from repro_torch.cluster.model import seed_tuned_cache

DEFAULT_BATCH_SIZES = (8, 16, 32, 64, 128, 256)


class PreparedBatch:
    """One pre-processed request batch, ready for the device thread."""

    __slots__ = ("ids", "vals", "nnz", "n_rows", "bucket")

    def __init__(self, ids, vals, nnz, n_rows: int, bucket: int):
        self.ids, self.vals, self.nnz = ids, vals, nnz
        self.n_rows = n_rows              # live rows (<= bucket)
        self.bucket = bucket              # padded batch size actually run

    @property
    def occupancy(self) -> float:
        return self.n_rows / self.bucket


class _BucketGraph:
    """One bucket's captured classify: static inputs, graph, outputs."""

    __slots__ = ("ids", "vals", "nnz", "graph", "assign", "sims")

    def __init__(self, ids, vals, nnz, graph, assign, sims):
        self.ids, self.vals, self.nnz, self.graph = ids, vals, nnz, graph
        self.assign, self.sims = assign, sims


class _Staging:
    """Pinned host buffers of one batch in flight and its event."""

    def __init__(self, rows: int, width: int):
        pin = lambda shape, dt: torch.empty(shape, dtype=dt, pin_memory=True)
        self.ids = pin((rows, width), torch.int32)
        self.vals = pin((rows, width), torch.float32)
        self.nnz = pin((rows,), torch.int32)
        self.assign = pin((rows,), torch.int32)
        self.sims = pin((rows,), torch.float32)
        self.event = torch.cuda.Event()


class ServableClusterModel:
    """A FittedModel wrapped for the continuous-batching service plane.

    model:       the :class:`repro_torch.cluster.FittedModel` to serve.
    batch_sizes: the padded batch-size buckets, any order (stored sorted
                 ascending as ``sorted_batch_sizes``); the largest bucket is
                 the per-launch row ceiling.
    pad_width:   static tuple width P every request is fitted to.  ``None``
                 (default) locks to the first batch's width; requests with
                 live tuples beyond the locked width fail with an error
                 naming the construction-time fix.
    device:      ``"cuda"`` (default; raises without a GPU) or ``"cpu"``
                 (eager, the plain versions).  The index is moved there.

    Building the servable puts the artifact's ``cuda_tuned`` winner into
    the autotuner's cache, as ``FittedModel.load`` does, so an in-memory
    hand-off from a fit gets it too; the classify itself launches the
    default tiles (``repro``'s servers read no tuned config either).
    A two-level artifact serves through the routed classify at its
    ``n_probe`` (``n_probe`` = K_c is the flat classify over its fine
    means, and serves as one).
    """

    def __init__(self, model, *, batch_sizes=DEFAULT_BATCH_SIZES,
                 pad_width: int | None = None, device="cuda"):
        sizes = tuple(sorted({int(b) for b in batch_sizes}))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
        self.device = resolve_device(device)
        seed_tuned_cache(getattr(model, "cuda_tuned", None))
        self.model = model
        self.index = model.index.to(self.device)
        self.n_probe = int(getattr(model, "n_probe", 0) or 0)
        self._routed = None
        if (getattr(model, "coarse_index", None) is not None
                and self.n_probe < model.coarse_k):
            self._routed = model._routed_operands(self.device)
        self.sorted_batch_sizes = sizes
        self._pad_width = None if pad_width is None else int(pad_width)
        self.dim = int(self.index.dim)
        self.k = int(self.index.k)
        self._lock = threading.Lock()
        self._captures = dict.fromkeys(sizes, 0)
        self._replays = dict.fromkeys(sizes, 0)
        self.capture_s: dict[int, float] = {}     # host seconds a capture
        self._graphs: dict[int, _BucketGraph] = {}
        self._free: list[_Staging] = []
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._warm_up()
            if self._pad_width is not None:
                self._capture_all()

    # -- CUDA graphs ----------------------------------------------------------
    def _classify(self, ids, vals, nnz):
        """(assign, sims) of a padded batch: the flat classify, or the
        routed one of a two-level model."""
        if self._routed is None:
            return _classify_fused(ids, vals, self.index.means_t)
        return _routed_fused(ids, vals, nnz, *self._routed, self.n_probe)[:2]

    def _warm_up(self):
        """One eager classify of a dead row: builds and loads the kernel
        libraries before any capture and before any serving thread runs."""
        with torch.cuda.stream(self._stream):
            z = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
            self._classify(z, z.float(), z[0])
        self._stream.synchronize()

    def _capture_all(self):
        """One graph per bucket at the locked width, and one staging slot."""
        p = self._pad_width
        for b in self.sorted_batch_sizes:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # The static inputs are zeroed on the stream the graph replays
            # on, so stream order puts that before any replay.  No device
            # synchronize, garbage collection or cache release around the
            # capture (torch.cuda.graph's context does all three): traffic
            # on other threads runs on meanwhile.
            with torch.cuda.stream(self._stream):
                ids = torch.zeros((b, p), dtype=torch.int32,
                                  device=self.device)
                vals = torch.zeros((b, p), dtype=torch.float32,
                                   device=self.device)
                nnz = torch.zeros((b,), dtype=torch.int32, device=self.device)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    assign, sims = self._classify(ids, vals, nnz)
                finally:
                    graph.capture_end()
            self._graphs[b] = _BucketGraph(ids, vals, nnz, graph, assign,
                                           sims)
            self._captures[b] += 1
            self.capture_s[b] = time.perf_counter() - t0
        self._free.append(_Staging(self.max_batch_size, p))

    def _take_staging(self) -> _Staging:
        with self._lock:
            if self._free:
                return self._free.pop()
        return _Staging(self.max_batch_size, self._pad_width)

    # -- bucket selection ---------------------------------------------------
    @property
    def max_batch_size(self) -> int:
        return self.sorted_batch_sizes[-1]

    @property
    def pad_width(self) -> int | None:
        return self._pad_width

    def get_padded_batch_size(self, n_rows: int) -> int:
        """Smallest bucket >= n_rows (the saxml selection rule).  The
        batcher never assembles past ``max_batch_size``, so a larger n is a
        caller bug and raises."""
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        i = bisect.bisect_left(self.sorted_batch_sizes, n_rows)
        if i == len(self.sorted_batch_sizes):
            raise ValueError(
                f"{n_rows} rows exceed the largest bucket "
                f"{self.max_batch_size}; split the request or construct the "
                f"servable with a larger batch_sizes ceiling")
        return self.sorted_batch_sizes[i]

    # -- the three stages -----------------------------------------------------
    def _lock_width(self, p_in: int) -> int:
        """The static width, locked to ``p_in`` (and the graphs captured)
        by the first batch when none was given."""
        with self._lock:
            if self._pad_width is None:
                self._pad_width = p_in
                if self.device.type == "cuda":
                    self._capture_all()
            return self._pad_width

    def _fit_width(self, ids, vals, nnz):
        """Fit (r, P_in) rows to the servable's static width (host-side)."""
        p_in = ids.shape[1]
        p = self._lock_width(p_in)
        if p_in == p:
            return ids, vals
        if p_in < p:
            wide_i = np.zeros((ids.shape[0], p), np.int32)
            wide_v = np.zeros((ids.shape[0], p), np.float32)
            wide_i[:, :p_in], wide_v[:, :p_in] = ids, vals
            return wide_i, wide_v
        if int(nnz.max(initial=0)) > p:
            raise ValueError(
                f"request rows carry up to {int(nnz.max())} live tuples but "
                f"this servable is locked to pad_width={p}; construct it "
                f"with pad_width>={int(nnz.max())}")
        # Rows are prefix-packed (live tuples occupy slots [0, nnz)), so a
        # narrowing slice only drops dead padding.
        return ids[:, :p], vals[:, :p]

    def pre_process(self, rows) -> PreparedBatch:
        """rows: list of (ids (r_i, P_i) int32, vals (r_i, P_i) float32,
        nnz (r_i,) int32) numpy triples (one per request) → PreparedBatch
        padded to the selected bucket with dead rows (nnz = 0, the repo-wide
        inert-row convention)."""
        fitted = [self._fit_width(np.asarray(i, np.int32),
                                  np.asarray(v, np.float32),
                                  np.asarray(z, np.int32))
                  + (np.asarray(z, np.int32),) for i, v, z in rows]
        ids = np.concatenate([f[0] for f in fitted])
        vals = np.concatenate([f[1] for f in fitted])
        nnz = np.concatenate([f[2] for f in fitted])
        n = ids.shape[0]
        bucket = self.get_padded_batch_size(n)
        if n < bucket:
            pad = bucket - n
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), np.int32)])
            vals = np.concatenate([vals,
                                   np.zeros((pad, vals.shape[1]), np.float32)])
            nnz = np.concatenate([nnz, np.zeros((pad,), np.int32)])
        return PreparedBatch(ids, vals, nnz, n, bucket)

    def device_compute(self, batch: PreparedBatch):
        """Classify one prepared batch.  On the card: copy-in, the bucket's
        graph replay and copy-out enqueued on the servable's stream, then
        an event; returns the batch's staging slot without a host sync.  On
        the CPU: the eager (assign, sims) tensors."""
        if self.device.type == "cpu":
            return self._classify(torch.from_numpy(batch.ids),
                                  torch.from_numpy(batch.vals),
                                  torch.from_numpy(batch.nnz))
        b = batch.bucket
        slot = self._take_staging()
        slot.ids[:b].numpy()[...] = batch.ids
        slot.vals[:b].numpy()[...] = batch.vals
        slot.nnz[:b].numpy()[...] = batch.nnz
        g = self._graphs[b]
        with self._lock, torch.cuda.stream(self._stream):
            g.ids.copy_(slot.ids[:b], non_blocking=True)
            g.vals.copy_(slot.vals[:b], non_blocking=True)
            g.nnz.copy_(slot.nnz[:b], non_blocking=True)
            g.graph.replay()
            slot.assign[:b].copy_(g.assign, non_blocking=True)
            slot.sims[:b].copy_(g.sims, non_blocking=True)
            slot.event.record(self._stream)
            self._replays[b] += 1
        return slot

    def post_process(self, out, n_rows: int):
        """Wait for the batch and trim the dead-row padding -> (assign
        (n_rows,) int32, sims (n_rows,) float32) numpy arrays."""
        if self.device.type == "cpu":
            a, s = out
            return a[:n_rows].numpy().copy(), s[:n_rows].numpy().copy()
        out.event.synchronize()
        a = out.assign[:n_rows].numpy().copy()
        s = out.sims[:n_rows].numpy().copy()
        with self._lock:
            self._free.append(out)
        return a, s

    # -- introspection --------------------------------------------------------
    def capture_counts(self) -> dict[int, int]:
        """{bucket: CUDA graph captures} (``repro``'s ``compile_counts``):
        at most 1 each, and 0 on the CPU, which captures nothing."""
        with self._lock:
            return dict(self._captures)

    def replay_counts(self) -> dict[int, int]:
        """{bucket: graph replays}, the launches of the bucket's kernels."""
        with self._lock:
            return dict(self._replays)

    def reset_replay_counts(self) -> None:
        with self._lock:
            self._replays = dict.fromkeys(self.sorted_batch_sizes, 0)
