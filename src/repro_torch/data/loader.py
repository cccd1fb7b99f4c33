"""Loader for the UCI "bag of words" format the paper's PubMed set uses
(counterpart of ``repro.data.loader``), local files only.

Format (docword.<name>.txt, optionally gzipped)::

    N
    D
    NNZ
    docID termID count     # 1-based ids, one triple per line

The rows go through the port's own tf_idf -> l2_normalize_rows ->
remap_terms_by_df on ``device``, as the synthetic corpora do.
"""
from __future__ import annotations

import gzip

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.matrix import (SparseDocs, df_counts,
                                       l2_normalize_rows, remap_terms_by_df,
                                       tf_idf, with_df)


def load_uci_bow(path: str, max_docs: int | None = None,
                 pad_to: int | None = None, *, device="cuda"):
    """-> (docs, df in remapped term order, perm), ``perm[new] = old``."""
    dev = resolve_device(device)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        n = int(f.readline())
        d = int(f.readline())
        int(f.readline())                         # NNZ
        triples = np.loadtxt(f, dtype=np.int64, ndmin=2)
    if max_docs is not None:
        triples = triples[triples[:, 0] <= max_docs]
        n = min(n, max_docs)
    doc = triples[:, 0] - 1
    term = triples[:, 1] - 1
    cnt = triples[:, 2].astype(np.float32)

    order = np.lexsort((term, doc))
    doc, term, cnt = doc[order], term[order], cnt[order]
    nnz = np.bincount(doc, minlength=n).astype(np.int32)
    pad = pad_to or int(nnz.max(initial=1))
    ids = np.zeros((n, pad), np.int32)
    vals = np.zeros((n, pad), np.float32)
    starts = np.concatenate([[0], np.cumsum(nnz)[:-1]])
    for i in range(n):
        k = min(nnz[i], pad)
        ids[i, :k] = term[starts[i]:starts[i] + k]
        vals[i, :k] = cnt[starts[i]:starts[i] + k]
    t = lambda a: torch.from_numpy(a).to(dev)
    docs = SparseDocs(t(ids), t(vals), t(np.minimum(nnz, pad)), d)
    df = df_counts(docs)
    docs = l2_normalize_rows(tf_idf(docs, df=df))
    docs, perm = remap_terms_by_df(docs, df=df)
    dfp = df[perm]                   # permuted counts == remapped corpus df
    return with_df(docs, dfp), dfp, perm
