"""Structured mean-inverted index (paper §IV-A) over a dense (D, K) matrix.

Counterpart of ``repro.core.meanindex``.  ``means_t (D, K)`` holds the
transposed means: row s is the posting list ξ_s in full expression, and the
gather kernels read its rows.  The shared thresholds (t_th, v_th) split it
into three regions:

    Region 1:  s <  t_th                      (exact)
    Region 2:  s >= t_th and v >= v_th        (exact)
    Region 3:  s >= t_th and v <  v_th        (bounded by y·v_th)

Memory at the NYT widths: one (D, K) float32 matrix is 19.8 GB, so nothing
here allocates another.  Every statistic walks the matrix in row chunks
(:func:`row_chunks`), :func:`normalized_means` normalises λ in place, and
the EstParams tables loop over their thresholds.  Sums whose rounding
matters never use the device's own reduction order: the column dots that
normalise the means and measure their drift repeat ``repro``'s float32
order (:func:`window_sum`), and the EstParams tables and sketches sum in
float64.

Unlike ``repro``, :func:`build_mean_index` takes the transposed
``means_t (D, K)`` (the port never holds (K, D) means), and the structural
parameters are host numbers, fixed on the host by EstParams.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (WINDOW, _sequential_sum, sqrt_rn,
                                     window_sum)

# Elements of one (rows, K) chunk of the means matrix.
CHUNK_ELEMS = 1 << 24

# Block-vector sketch width (see repro.core.meanindex): S <= SKETCH_DIM
# groups of g contiguous terms, each summarised by its L2 norm.
SKETCH_DIM = 64


def row_chunks(d: int, k: int):
    """(start, end) row ranges of a (d, k) matrix, CHUNK_ELEMS at a time."""
    step = max(1, CHUNK_ELEMS // max(k, 1))
    for s in range(0, d, step):
        yield s, min(s + step, d)


def sketch_group_width(dim: int) -> int:
    return -(-dim // SKETCH_DIM)


def sketch_size(dim: int) -> int:
    g = sketch_group_width(dim)
    return -(-dim // g)


def _group_norms(means_t: torch.Tensor, t_th: int = 0,
                 v_th: float | None = None) -> torch.Tensor:
    """(S, K) per-group L2 norms of the rows s >= t_th of ``means_t``,
    keeping only entries below ``v_th`` when it is given.

    Walks each group's rows in chunks, so no (D, K) temporary exists.  The
    float32 squares are summed in float64, so the float32 sum does not hang
    on the device's reduction order (it could only differ where two
    float64 sums straddle a float32 rounding boundary).
    """
    d, k = means_t.shape
    g = sketch_group_width(d)
    out = torch.zeros((sketch_size(d), k), dtype=torch.float32,
                      device=means_t.device)
    t0 = min(max(int(t_th), 0), d)
    for s in range(t0 // g, out.shape[0]):
        lo, hi = max(s * g, t0), min((s + 1) * g, d)
        acc = torch.zeros((k,), dtype=torch.float64, device=means_t.device)
        for a, b in row_chunks(hi - lo, k):
            blk = means_t[lo + a:lo + b]
            if v_th is not None:
                blk = torch.where(blk < v_th, blk, 0.0)
            acc += (blk * blk).sum(dim=0, dtype=torch.float64)
        out[s] = sqrt_rn(acc.to(torch.float32))
    return out


def sketch_means(means_t: torch.Tensor) -> torch.Tensor:
    """(D, K) -> (S, K): slot s holds the L2 norm of rows [s·g, (s+1)·g)
    per centroid, reduced group by group."""
    return _group_norms(means_t)


def doc_sketch(ids: torch.Tensor, vals: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """(B, P) padded tuple rows -> (B, S) block-vector sketch (the
    ``doc_sketch`` kernel).  Dead slots carry value 0 and add nothing,
    whatever their id."""
    return ops.doc_sketch(ids, vals, dim, sketch_size(dim))


@dataclasses.dataclass(frozen=True)
class StructuralParams:
    """Shared thresholds (t_th, v_th) — paper Table III.  Host numbers:
    ``t_th`` a term id in df-rank space, ``v_th`` a float32 value."""

    t_th: int
    v_th: float

    def __post_init__(self):
        object.__setattr__(self, "t_th", int(self.t_th))
        # Hold v_th at float32 precision, the precision it is compared in.
        object.__setattr__(self, "v_th", float(
            torch.tensor(float(self.v_th), dtype=torch.float32)))

    @staticmethod
    def trivial(dim: int) -> StructuralParams:
        """t_th = 0, v_th = 1: Regions 1 and 2 empty — a pure L1 bound."""
        return StructuralParams(t_th=0, v_th=1.0)


@dataclasses.dataclass(frozen=True)
class MeanIndex:
    """Mean set + the derived statistics every filter needs.

    means_t:  (D, K) float32 — transposed means; row s = posting list ξ_s.
    mf:       (D,) int32     — nonzeros in row s.
    moving:   (K,) bool      — centroid moved at the last update (ICP state).
    n_moving: () int64       — number of moving centroids (a device scalar).
    params:   StructuralParams.
    mf_h:     (D,) int32     — entries with v >= v_th in rows s >= t_th.
    sketch_t: (S, K) float32 — block-vector sketch of the means.
    """

    means_t: torch.Tensor
    mf: torch.Tensor
    moving: torch.Tensor
    n_moving: torch.Tensor
    params: StructuralParams
    mf_h: torch.Tensor
    sketch_t: torch.Tensor

    @property
    def dim(self) -> int:
        return self.means_t.shape[0]

    @property
    def k(self) -> int:
        return self.means_t.shape[1]

    def to(self, device) -> MeanIndex:
        """This index on ``device`` (self when it is there already)."""
        dev = torch.device(device)
        here = self.means_t.device
        if here.type == dev.type and dev.index in (None, here.index):
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def with_params(self, params: StructuralParams) -> MeanIndex:
        """The same means under new thresholds (only mf_h depends on them)."""
        return dataclasses.replace(self, params=params,
                                   mf_h=_mf_high(self.means_t, params))


def _mf_counts(means_t: torch.Tensor) -> torch.Tensor:
    d, k = means_t.shape
    mf = torch.empty((d,), dtype=torch.int32, device=means_t.device)
    for s, e in row_chunks(d, k):
        mf[s:e] = (means_t[s:e] > 0).sum(dim=1, dtype=torch.int32)
    return mf


def _mf_high(means_t: torch.Tensor, params: StructuralParams) -> torch.Tensor:
    d, k = means_t.shape
    mf_h = torch.zeros((d,), dtype=torch.int32, device=means_t.device)
    t0 = min(max(params.t_th, 0), d)
    for s, e in row_chunks(d - t0, k):
        blk = means_t[t0 + s:t0 + e]
        mf_h[t0 + s:t0 + e] = (blk >= params.v_th).sum(dim=1,
                                                       dtype=torch.int32)
    return mf_h


def build_mean_index(means_t: torch.Tensor, params: StructuralParams,
                     moving: torch.Tensor | None = None) -> MeanIndex:
    """means_t: (D, K) L2-normalised transposed means -> MeanIndex."""
    d, k = means_t.shape
    if moving is None:
        moving = torch.ones((k,), dtype=torch.bool, device=means_t.device)
    return MeanIndex(means_t=means_t, mf=_mf_counts(means_t), moving=moving,
                     n_moving=moving.sum(), params=params,
                     mf_h=_mf_high(means_t, params),
                     sketch_t=sketch_means(means_t))


def column_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K,) float32 Σ_d a[d, k]·b[d, k] in ``repro``'s order
    (:func:`window_sum`), computed a few thousand rows at a time so no
    (D, K) product temporary exists."""
    d, k = a.shape
    if d <= WINDOW:
        return window_sum(a * b)
    pad = -d % WINDOW
    lo = pad // 2
    n_win = (d + pad) // WINDOW
    partial = torch.empty((n_win, k), dtype=torch.float32, device=a.device)
    step = max(1, 4 * CHUNK_ELEMS // (WINDOW * max(k, 1)))
    for j0 in range(0, n_win, step):
        j1 = min(j0 + step, n_win)
        r0, r1 = j0 * WINDOW - lo, j1 * WINDOW - lo   # padded window rows
        s, e = max(r0, 0), min(r1, d)
        prod = torch.nn.functional.pad(a[s:e] * b[s:e], (0, 0, s - r0, r1 - e))
        partial[j0:j1] = _sequential_sum(prod.view(j1 - j0, WINDOW, k), 1)
    return window_sum(partial)


def normalized_means(lam_t: torch.Tensor,
                     fallback_means_t: torch.Tensor) -> torch.Tensor:
    """Unit-norm transposed means from the cluster sums λ_t (D, K), IN PLACE.

    Each column is divided by its L2 norm; an empty cluster (zero norm)
    keeps its previous mean, copied from ``fallback_means_t`` for those
    columns only.  Returns ``lam_t``, which now holds the means.
    """
    norms = sqrt_rn(column_dots(lam_t, lam_t))
    lam_t.div_(torch.clamp(norms, min=1e-12))
    empty = torch.nonzero(norms == 0.0).flatten()
    if empty.numel():
        lam_t[:, empty] = fallback_means_t[:, empty]
    return lam_t


def region3_sketch(index: MeanIndex) -> torch.Tensor:
    """(S, K) per-group L2 norms of each centroid's Region-3 entries
    (rows s >= t_th with v < v_th) — the mean side of ``bounds-esicp``'s
    sketch-refined Region-3 bound.  It depends on the means and the
    thresholds alone, so a fit computes it once per assignment epoch.
    Only the groups at or past t_th are read."""
    return _group_norms(index.means_t, index.params.t_th, index.params.v_th)
