"""UC-faithful synthetic corpus generator (counterpart of
``repro.data.synthetic``), bit-identical to ``repro``'s for one spec.

The corpus follows the paper's universal characteristics: Zipf's law on
term frequency, (nt/D) << 1 sparsity, tf-idf weighting with L2
normalisation, and a latent topic mixture so that k-means finds structure.

The host draw is numpy and consumes the generator exactly as ``repro``
does.  ``repro`` draws each document with ``Generator.choice(vocab, p=...)``,
which rebuilds a vocab-sized CDF per call; here each topic's CDF is built
once and every draw is ``cdf.searchsorted(rng.random(n), side="right")`` —
the same draws, and the generator left in the same state, as ``choice``.
The documents of one topic take their uniforms in one ``rng.random`` call,
which is the concatenation of the per-document calls.  The tf-idf, L2 and
df-remap steps then run in torch on the requested device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.matrix import (SparseDocs, df_counts,
                                       l2_normalize_rows, remap_terms_by_df,
                                       tf_idf, with_df)


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 20_000
    vocab: int = 8_192
    nt_mean: float = 60.0        # paper PubMed: 58.96 distinct terms / doc
    zipf_alpha: float = 1.05     # exponent of the rank-frequency law
    n_topics: int = 64           # latent clusters (drives mean concentration)
    topic_sharpness: float = 200.0
    pad_to: int | None = None
    seed: int = 0


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def _draw_tuples(spec: CorpusSpec):
    """Host draw: (ids, vals, nnz, topics) numpy arrays, before weighting."""
    rng = np.random.default_rng(spec.seed)
    base = _zipf_probs(spec.vocab, spec.zipf_alpha)

    n_head = max(4, spec.vocab // 256)
    topic_boost = np.ones((spec.n_topics, spec.vocab))
    for t in range(spec.n_topics):
        head = rng.choice(spec.vocab, size=n_head, replace=False)
        topic_boost[t, head] *= spec.topic_sharpness
    topic_p = base[None, :] * topic_boost
    del topic_boost
    topic_p /= topic_p.sum(axis=1, keepdims=True)

    topics = rng.integers(0, spec.n_topics, size=spec.n_docs)
    lengths = np.clip(rng.poisson(spec.nt_mean * 1.6, size=spec.n_docs), 8,
                      None)

    pad = spec.pad_to or int(np.quantile(lengths, 0.999) + 8)
    ids = np.zeros((spec.n_docs, pad), np.int32)
    vals = np.zeros((spec.n_docs, pad), np.float32)
    nnz = np.zeros((spec.n_docs,), np.int32)

    for t in range(spec.n_topics):
        (docs_t,) = np.nonzero(topics == t)
        if docs_t.size == 0:
            continue
        cdf = topic_p[t].cumsum()
        cdf /= cdf[-1]
        lens = lengths[docs_t]
        draws = cdf.searchsorted(rng.random(int(lens.sum())), side="right")
        # Distinct terms per document, ascending, with their counts: one
        # np.unique over (document, term) keys replaces the per-doc calls.
        owner = np.repeat(np.arange(docs_t.size, dtype=np.int64), lens)
        keys, counts = np.unique(owner * spec.vocab + draws,
                                 return_counts=True)
        doc = keys // spec.vocab
        term = keys % spec.vocab
        first = np.searchsorted(doc, np.arange(docs_t.size))
        rank = np.arange(keys.size) - first[doc]
        keep = rank < pad                      # repro keeps terms[:pad]
        rows = docs_t[doc[keep]]
        ids[rows, rank[keep]] = term[keep]
        vals[rows, rank[keep]] = counts[keep].astype(np.float32)
        nnz[docs_t] = np.minimum(np.bincount(doc, minlength=docs_t.size), pad)
    return ids, vals, nnz, topics


def make_corpus(spec: CorpusSpec, *, device="cuda"):
    """Returns (docs: SparseDocs tf-idf L2-normalised df-rank-remapped,
    df: (D,) int32, perm: new->old term permutation, topics: (N,) labels),
    all on ``device``."""
    dev = resolve_device(device)
    ids, vals, nnz, topics = _draw_tuples(spec)
    docs = SparseDocs(torch.from_numpy(ids).to(dev),
                      torch.from_numpy(vals).to(dev),
                      torch.from_numpy(nnz).to(dev), spec.vocab)
    df = df_counts(docs)
    docs = tf_idf(docs, df=df)
    docs = l2_normalize_rows(docs)
    docs, perm = remap_terms_by_df(docs, df=df)
    df_sorted = df[perm]
    docs = with_df(docs, df_sorted)
    return docs, df_sorted, perm, torch.from_numpy(topics).to(dev)
