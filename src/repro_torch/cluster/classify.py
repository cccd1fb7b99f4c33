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
graphs (:mod:`repro_torch.serve.servable`) and ``ClusterEngine.refit``;
:func:`_routed_fused` is its two-level twin (``classify_docs_routed``).
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


def _routed_fused(ids, vals, nnz, coarse_t, means_t, starts, sizes,
                  cmax: int, n_probe: int):
    """One fixed-shape routed classify of a padded (B, P) batch against a
    two-level model -> (assign (B,) int32 global fine ids, sims (B,)
    float32, scored (B,) int32): ``sparse_sim`` against the K_c coarse
    means, each row's ``n_probe`` best cells (a stable descending sort:
    the lower cell first among equal scores, ``lax.top_k``'s order), then
    the ``routed_scan`` kernel over those cells' fine means.  No host
    sync, so a CUDA graph capture can hold it."""
    csims = ops.sparse_sim(ids, vals, coarse_t)[0]
    cells = torch.sort(csims, dim=1, descending=True, stable=True).indices
    return ops.routed_scan(ids, vals, nnz, means_t,
                           cells[:, :n_probe].to(torch.int32).contiguous(),
                           starts, sizes, cmax)


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


def classify_docs_routed(model, docs, *, n_probe: int | None = None,
                         batch_size: int = 4096, with_stats: bool = False,
                         device=None):
    """docs vs a two-level model -> (assign (N,) int32, sims (N,)
    float32[, scored (N,) int32]), the coarse-routed classify.

    ``model`` is a :class:`repro_torch.cluster.model.TwoLevelFittedModel`;
    ``assign`` holds global fine ids, as the flat classify over
    ``model.index`` does.  ``n_probe`` defaults to the model's; at
    n_probe = K_c every cell is probed and the call is the flat
    :func:`classify_docs`.  ``scored`` counts the centroids scored per
    document: K_c + Σ probed cell sizes (K_eff when delegating).  ``docs``
    is resident SparseDocs or a DocStore.
    """
    n_probe = model.n_probe if n_probe is None else int(n_probe)
    k_c = model.coarse_k
    if not 1 <= n_probe <= k_c:
        raise ValueError(f"n_probe must be in [1, coarse_k={k_c}], "
                         f"got {n_probe}")
    if n_probe == k_c:
        a, s = classify_docs(model.index, docs, batch_size=batch_size,
                             device=device)
        return (a, s, torch.full_like(a, model.index.k)) if with_stats \
            else (a, s)
    dev = resolve_device(model.device if device is None else device)
    operands = model._routed_operands(dev)
    n = docs.n_docs
    out = (torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev))
    for s0, span, bs in _spans(docs, dev, batch_size):
        for s in range(0, span.n_docs, bs):
            b = span.slice_rows(s, bs)
            got = _routed_fused(b.ids, b.vals, b.nnz, *operands, n_probe)
            for o, g in zip(out, got):
                o[s0 + s:s0 + s + b.n_docs] = g
    return out if with_stats else out[:2]


def transform_docs(index, docs, *, batch_size: int = 4096, device=None):
    """docs vs a MeanIndex -> dense (N, K) float32 cosine similarities."""
    dev, means_t, n, batches = _batches(index, docs, batch_size, device)
    out = torch.empty((n, index.k), dtype=torch.float32, device=dev)
    for s, b in batches:
        out[s:s + b.n_docs] = ops.sparse_sim(b.ids, b.vals, means_t)[0]
    return out
