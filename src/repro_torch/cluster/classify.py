"""Classification against a frozen index (counterpart of
``repro.cluster.classify``: ``classify_docs``, ``transform_docs``): exact
similarities from the ``sparse_sim`` kernel, top-1 per row (first maximum
on ties).  ``docs`` is resident SparseDocs or a
:class:`repro_torch.sparse.store.DocStore`, whose chunks stream through
the prefetcher with their dead tail rows trimmed; each row's result does
not depend on its batch, so the store path equals the resident one bit for
bit.

:func:`_classify_fused` is the one classify of a batch that every runtime
shares: the batches of :func:`classify_docs`, the serving plane's CUDA
graphs (:mod:`repro_torch.serve.servable`) and ``ClusterEngine.refit``.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sparse.store import ChunkPrefetcher, DocStore


def _classify_fused(ids, vals, means_t):
    """One fixed-shape classify of a padded (B, P) batch -> (assign (B,)
    int32, sims (B,) float32): ``sparse_sim``, then the first maximum of
    each row and its sim.  No host sync, and its only allocations are on
    the current stream, so a CUDA graph capture can hold it.  A dead row
    (no live slot) scores 0 everywhere and takes centroid 0."""
    scores = ops.sparse_sim(ids, vals, means_t)[0]
    best = torch.argmax(scores, dim=1)
    return best.to(torch.int32), torch.gather(scores, 1, best[:, None])[:, 0]


def _store_tiles(store: DocStore, batch_size: int):
    """(tile rows, per-chunk trimmer) for scanning a store's (C, P) chunks:
    tiles of min(batch_size, C) rows, and ``trim(ci, chunk)`` drops the
    chunk's dead tail rows before any kernel sees them (``repro`` pads
    them to a tile multiple instead; a row's result does not depend on its
    tile, so both give the resident answer)."""
    bs = max(min(batch_size, store.chunk_size), 1)
    return bs, lambda ci, cdocs: cdocs.slice_rows(0, store.n_valid(ci))


def _spans(docs, dev, batch_size: int):
    """(row offset, SparseDocs on ``dev``, tile rows) covering ``docs``'
    real rows: one span for resident documents, one per chunk for a
    store."""
    if isinstance(docs, DocStore):
        bs, trim = _store_tiles(docs, batch_size)
        for ci, cdocs in ChunkPrefetcher(docs, device=dev):
            yield ci * docs.chunk_size, trim(ci, cdocs), bs
    else:
        yield 0, docs.to(dev).validate(), max(1, batch_size)


def _batches(index, docs, batch_size: int, device):
    """(device, means_t there, N, generator of (row offset, batch))."""
    dev = resolve_device(index.means_t.device if device is None else device)

    def gen():
        for s0, span, bs in _spans(docs, dev, batch_size):
            for s in range(0, span.n_docs, bs):
                yield s0 + s, span.slice_rows(s, bs)

    return dev, index.means_t.to(dev), docs.n_docs, gen()


def classify_docs(index, docs, *, batch_size: int = 4096, device=None):
    """docs vs a MeanIndex -> (assign (N,) int32, sims (N,) float32) on the
    index's device (or ``device``, where docs and index are moved)."""
    dev, means_t, n, batches = _batches(index, docs, batch_size, device)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    sims = torch.empty((n,), dtype=torch.float32, device=dev)
    for s, b in batches:
        e = s + b.n_docs
        assign[s:e], sims[s:e] = _classify_fused(b.ids, b.vals, means_t)
    return assign, sims


def transform_docs(index, docs, *, batch_size: int = 4096, device=None):
    """docs vs a MeanIndex -> dense (N, K) float32 cosine similarities."""
    dev, means_t, n, batches = _batches(index, docs, batch_size, device)
    out = torch.empty((n, index.k), dtype=torch.float32, device=dev)
    for s, b in batches:
        out[s:s + b.n_docs] = ops.sparse_sim(b.ids, b.vals, means_t)[0]
    return out
