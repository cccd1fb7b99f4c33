"""Clustering quality and the paper's diagnostics (counterpart of
``repro.core.metrics``; App. H–I, Figs. 2–4).

``nmi``, ``pairwise_nmi``, ``coefficient_of_variation`` and ``zipf_fit``
are numpy (copied from ``repro``; torch tensors are read on the host).
``objective``, ``cps_curve`` and ``mean_value_skew`` run on the tensors'
device: ``cps_curve`` gathers each live tuple's mean entry (rows in
chunks), ``mean_value_skew`` reads the (D, K) means once, row chunk by row
chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.estparams import linspace_f32
from repro_torch.core.meanindex import row_chunks
from repro_torch.kernels.ref import CHUNK_ELEMS
from repro_torch.sparse.matrix import SparseDocs


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def objective(rho_self) -> float:
    """J(C) = Σ_i x_i·μ_{a(i)} (Eq. 47), summed in float64."""
    return float(torch.as_tensor(rho_self).double().sum())


def nmi(a, b) -> float:
    """Normalized mutual information (Eq. 49), sparse contingency."""
    a = _np(a)
    b = _np(b)
    n = len(a)
    pairs = a.astype(np.int64) * (b.max() + 1) + b
    _, counts = np.unique(pairs, return_counts=True)
    pab = counts / n
    _, ca = np.unique(a, return_counts=True)
    _, cb = np.unique(b, return_counts=True)
    pa = ca / n
    pb = cb / n
    ha = -np.sum(pa * np.log(pa))
    hb = -np.sum(pb * np.log(pb))
    hab = -np.sum(pab * np.log(pab))     # I = H(a) + H(b) - H(a,b)
    i = ha + hb - hab
    denom = np.sqrt(ha * hb)
    return float(i / denom) if denom > 0 else 1.0


def pairwise_nmi(assignments: list) -> tuple[float, float]:
    """Mean/std of NMI over all pairs (Eq. 50)."""
    vals = [nmi(assignments[i], assignments[j])
            for i in range(len(assignments))
            for j in range(i + 1, len(assignments))]
    return float(np.mean(vals)), float(np.std(vals))


def coefficient_of_variation(xs) -> float:
    xs = _np(xs).astype(np.float64)
    m = xs.mean()
    return float(xs.std() / m) if m != 0 else 0.0


def cps_curve(docs: SparseDocs, means_t: torch.Tensor, assign,
              n_bins: int = 100):
    """Average cumulative partial similarity vs normalized rank (App. I).

    Returns (nr, cps_mean, cps_std) as numpy arrays: the paper reports
    CPS(0.1) ≈ 0.92 for PubMed — 10% of the multiplications give 92% of
    the similarity.
    """
    dev = means_t.device
    assign = torch.as_tensor(assign).to(dev).long()
    n, p = docs.ids.shape
    nr = linspace_f32(0.0, 1.0, n_bins + 1).to(dev)
    sampled = torch.empty((n, n_bins + 1), dtype=torch.float32, device=dev)
    step = max(1, CHUNK_ELEMS // max(p, 1))
    for s in range(0, n, step):
        e = min(s + step, n)
        ids, vals, nnz = (docs.ids[s:e].to(dev), docs.vals[s:e].to(dev),
                          docs.nnz[s:e].to(dev))
        live = torch.arange(p, device=dev)[None, :] < nnz[:, None]
        partial = torch.where(live, vals * means_t[ids.long(),
                                                   assign[s:e, None]], 0.0)
        csum = torch.cumsum(torch.sort(partial, dim=1,
                                       descending=True).values, dim=1)
        frac = csum / torch.clamp(csum[:, -1:], min=1e-12)
        # each row at h = ceil(nr · nnz) - 1, clipped
        idx = (torch.ceil(nr[None, :] * nnz[:, None].to(torch.float32))
               .to(torch.int64) - 1).clamp(0, p - 1)
        got = torch.gather(frac, 1, idx)
        sampled[s:e] = torch.where(nr[None, :] == 0.0, 0.0, got)
    return (_np(nr), _np(sampled.mean(dim=0)),
            _np(sampled.std(dim=0, correction=0)))


def zipf_fit(freqs) -> float:
    """OLS slope of log-freq vs log-rank (descending) — Zipf exponent α."""
    f = np.sort(_np(freqs).astype(np.float64))[::-1]
    f = f[f > 0]
    r = np.arange(1, len(f) + 1)
    lo, hi = int(0.01 * len(f)), int(0.7 * len(f))  # the body, not the tails
    x = np.log(r[lo:hi])
    y = np.log(f[lo:hi])
    return float(-np.polyfit(x, y, 1)[0])


def mean_value_skew(means_t: torch.Tensor) -> dict:
    """Feature-value concentration (Fig. 4a / 9): the fraction of centroids
    whose largest value exceeds 1/sqrt(2), and the mean top-1/total mass.
    One pass over the (D, K) means (column sums in float64)."""
    d, k = means_t.shape
    col_max = torch.full((k,), -torch.inf, device=means_t.device)
    col_sum = torch.zeros((k,), dtype=torch.float64, device=means_t.device)
    for s, e in row_chunks(d, k):
        blk = means_t[s:e]
        col_max = torch.maximum(col_max, blk.amax(dim=0))
        col_sum += blk.sum(dim=0, dtype=torch.float64)
    col_sum = torch.clamp(col_sum.to(torch.float32), min=1e-12)
    return {
        "frac_dominant": float((col_max > 1.0 / np.sqrt(2.0)).double()
                               .mean()),
        "top1_mass_mean": float((col_max / col_sum).double().mean()),
    }
