"""Classification against a frozen index (counterpart of
``repro.cluster.classify.classify_docs``, resident docs only): exact
similarities from the ``sparse_sim`` kernel, top-1 per row (first maximum
on ties)."""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops


def classify_docs(index, docs, *, batch_size: int = 4096, device=None):
    """docs vs a MeanIndex -> (assign (N,) int32, sims (N,) float32) on the
    index's device (or ``device``, where docs and index are moved)."""
    dev = resolve_device(index.means_t.device if device is None else device)
    docs = docs.to(dev).validate()
    means_t = index.means_t.to(dev)
    n = docs.n_docs
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    sims = torch.empty((n,), dtype=torch.float32, device=dev)
    bs = max(1, batch_size)
    for s in range(0, n, bs):
        b = docs.slice_rows(s, bs)
        scores, _ = ops.sparse_sim(b.ids, b.vals, means_t)
        best = torch.argmax(scores, dim=1)
        assign[s:s + b.n_docs] = best.to(torch.int32)
        sims[s:s + b.n_docs] = torch.gather(scores, 1, best[:, None])[:, 0]
    return assign, sims
