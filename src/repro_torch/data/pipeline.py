"""Sharded, prefetching batch pipeline (counterpart of
``repro.data.pipeline``).

Deterministic: batch b of epoch e is a function of (seed, e, b) alone
(``numpy.random.default_rng((seed, e))``'s permutation, ``repro``'s draw),
so a restarted job resumes mid-epoch from its (epoch, batch) cursor and
every rank of a mesh sees the same batch.  With a mesh, each rank yields
its slice of each batch: the rows of its object shard (``repro`` places
the batch sharded over the object axes; the centroid state lives on
"model", so the pipeline never needs it).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.matrix import SparseDocs


class ShardedBatches:
    """Iterates padded SparseDocs minibatches on ``device``.

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, or None for the
    whole batch) gives each rank rows [i·B/n, (i+1)·B/n) of every batch,
    i its object index and n the object ranks; ``batch`` must divide by
    n.  The ragged final batch (``drop_remainder=False``) pads with empty
    rows (ids 0, vals 0, nnz 0), as ``repro`` pads it.
    """

    def __init__(self, docs: SparseDocs, batch: int, *, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 mesh=None, prefetch: int = 2, device="cuda"):
        if drop_remainder and docs.n_docs < batch:
            raise ValueError(f"batch {batch} > corpus {docs.n_docs}")
        n_shards = 1 if mesh is None else mesh.object_size
        if batch % n_shards:
            raise ValueError(f"batch {batch} must divide over the mesh's "
                             f"{n_shards} object shards")
        self.docs = docs
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.device = resolve_device(device)
        part = batch // n_shards
        self._rows = slice(0, batch) if mesh is None else slice(
            mesh.object_index * part, (mesh.object_index + 1) * part)
        self._ids = docs.ids.cpu().numpy()
        self._vals = docs.vals.cpu().numpy()
        self._nnz = docs.nnz.cpu().numpy()

    def __len__(self) -> int:
        n = self.docs.n_docs
        return n // self.batch if self.drop_remainder else -(-n // self.batch)

    def _order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.docs.n_docs)
        return np.random.default_rng((self.seed, epoch)).permutation(
            self.docs.n_docs)

    def _make(self, order: np.ndarray, b: int) -> SparseDocs:
        sel = order[b * self.batch:(b + 1) * self.batch]
        ids, vals, nnz = self._ids[sel], self._vals[sel], self._nnz[sel]
        if len(sel) < self.batch:        # the ragged final batch
            pad = self.batch - len(sel)
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]),
                                                ids.dtype)])
            vals = np.concatenate([vals, np.zeros((pad, vals.shape[1]),
                                                  vals.dtype)])
            nnz = np.concatenate([nnz, np.zeros((pad,), nnz.dtype)])
        put = lambda a: torch.from_numpy(
            np.ascontiguousarray(a[self._rows])).to(self.device)
        return SparseDocs(put(ids), put(vals), put(nnz), self.docs.dim)

    def epoch(self, epoch: int = 0, start_batch: int = 0
              ) -> Iterator[SparseDocs]:
        """Prefetching iterator over one epoch, resumable at
        ``start_batch``; a producer thread builds up to ``prefetch``
        batches ahead and stops when the iterator is closed."""
        order = self._order(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop, done = object(), threading.Event()

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(start_batch, len(self)):
                    if not put(self._make(order, b)):
                        return
            except BaseException as e:    # re-raised by the consumer
                put(e)
            put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            done.set()
            t.join(timeout=10)
