"""Classification against a frozen index (counterpart of
``repro.cluster.classify``: ``classify_docs``, ``transform_docs``): exact
similarities from the ``sparse_sim`` kernel, top-1 per row (first maximum
on ties).  ``docs`` is resident SparseDocs or a
:class:`repro_torch.sparse.store.DocStore`, whose chunks stream through
the prefetcher with their dead tail rows trimmed; each row's result does
not depend on its batch, so the store path equals the resident one bit for
bit."""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sparse.store import ChunkPrefetcher, DocStore


def _spans(docs, dev):
    """(row offset, SparseDocs on ``dev``) covering ``docs``' real rows:
    one span for resident documents, one per chunk for a store."""
    if isinstance(docs, DocStore):
        for ci, cdocs in ChunkPrefetcher(docs, device=dev):
            yield ci * docs.chunk_size, cdocs.slice_rows(0, docs.n_valid(ci))
    else:
        yield 0, docs.to(dev).validate()


def _batches(index, docs, batch_size: int, device):
    """(device, N, generator of (row offset, (b, K) float32 sims))."""
    dev = resolve_device(index.means_t.device if device is None else device)
    means_t = index.means_t.to(dev)
    bs = max(1, batch_size)

    def gen():
        for s0, span in _spans(docs, dev):
            for s in range(0, span.n_docs, bs):
                b = span.slice_rows(s, bs)
                yield s0 + s, ops.sparse_sim(b.ids, b.vals, means_t)[0]

    return dev, docs.n_docs, gen()


def classify_docs(index, docs, *, batch_size: int = 4096, device=None):
    """docs vs a MeanIndex -> (assign (N,) int32, sims (N,) float32) on the
    index's device (or ``device``, where docs and index are moved)."""
    dev, n, scored = _batches(index, docs, batch_size, device)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    sims = torch.empty((n,), dtype=torch.float32, device=dev)
    for s, scores in scored:
        best = torch.argmax(scores, dim=1)
        e = s + scores.shape[0]
        assign[s:e] = best.to(torch.int32)
        sims[s:e] = torch.gather(scores, 1, best[:, None])[:, 0]
    return assign, sims


def transform_docs(index, docs, *, batch_size: int = 4096, device=None):
    """docs vs a MeanIndex -> dense (N, K) float32 cosine similarities."""
    dev, n, scored = _batches(index, docs, batch_size, device)
    out = torch.empty((n, index.k), dtype=torch.float32, device=dev)
    for s, scores in scored:
        out[s:s + scores.shape[0]] = scores
    return out
