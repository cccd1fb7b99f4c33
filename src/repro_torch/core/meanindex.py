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
the EstParams tables loop over their thresholds.  Column sums that feed a
division or a threshold are accumulated in float64, so their rounding does
not depend on the reduction order of the device.

Unlike ``repro``, :func:`build_mean_index` takes the transposed
``means_t (D, K)`` (the port never holds (K, D) means), and the structural
parameters are host numbers, fixed on the host by EstParams.
"""
from __future__ import annotations

import dataclasses

import torch

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


def sketch_means(means_t: torch.Tensor) -> torch.Tensor:
    """(D, K) -> (S, K): slot s holds the L2 norm of rows [s·g, (s+1)·g)
    per centroid, reduced group by group."""
    d, k = means_t.shape
    g = sketch_group_width(d)
    out = torch.empty((sketch_size(d), k), dtype=torch.float32,
                      device=means_t.device)
    for s in range(out.shape[0]):
        acc = torch.zeros((k,), dtype=torch.float32, device=means_t.device)
        for a, b in row_chunks(min(g, d - s * g), k):
            blk = means_t[s * g + a:s * g + b]
            acc += (blk * blk).sum(dim=0)
        out[s] = torch.sqrt(acc)
    return out


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
    """(K,) float64 Σ_d a[d, k]·b[d, k], accumulated in float64 by row chunk."""
    d, k = a.shape
    acc = torch.zeros((k,), dtype=torch.float64, device=a.device)
    for s, e in row_chunks(d, k):
        acc += (a[s:e].double() * b[s:e].double()).sum(dim=0)
    return acc


def normalized_means(lam_t: torch.Tensor,
                     fallback_means_t: torch.Tensor) -> torch.Tensor:
    """Unit-norm transposed means from the cluster sums λ_t (D, K), IN PLACE.

    Each column is divided by its L2 norm; an empty cluster (zero norm)
    keeps its previous mean, copied from ``fallback_means_t`` for those
    columns only.  Returns ``lam_t``, which now holds the means.
    """
    norms = torch.sqrt(column_dots(lam_t, lam_t)).to(torch.float32)
    lam_t.div_(torch.clamp(norms, min=1e-12))
    empty = torch.nonzero(norms == 0.0).flatten()
    if empty.numel():
        lam_t[:, empty] = fallback_means_t[:, empty]
    return lam_t


def mean_value_stats(means_t: torch.Tensor) -> torch.Tensor:
    """(D,) float64 Σ_k v_{s,k} (Eq. 32 inner sum), by row chunk."""
    d, k = means_t.shape
    out = torch.empty((d,), dtype=torch.float64, device=means_t.device)
    for s, e in row_chunks(d, k):
        out[s:e] = means_t[s:e].double().sum(dim=1)
    return out


def delta_v_bar(means_t: torch.Tensor, v_grid) -> torch.Tensor:
    """Δv̄_{s,h} = (1/K) Σ_k relu(v_h − v_{s,k}) — Eq. (39), (D, H) float64.

    Absent centroids (v = 0) count, matching the (K − mf_s)·v_h term.  The
    relu is float32 (as in ``repro``); the mean is a float64 sum.
    """
    d, k = means_t.shape
    v_grid = [float(v) for v in v_grid]
    out = torch.empty((d, len(v_grid)), dtype=torch.float64,
                      device=means_t.device)
    for s, e in row_chunks(d, k):
        blk = means_t[s:e]
        for h, v_h in enumerate(v_grid):
            out[s:e, h] = torch.clamp(v_h - blk, min=0.0).double().sum(dim=1)
    return out / k


def mfh_table(means_t: torch.Tensor, v_grid) -> torch.Tensor:
    """(mfH)_{s,h} = #{k : v_{s,k} >= v_h} for every candidate — (D, H) int32."""
    d, k = means_t.shape
    v_grid = [float(v) for v in v_grid]
    out = torch.empty((d, len(v_grid)), dtype=torch.int32,
                      device=means_t.device)
    for s, e in row_chunks(d, k):
        blk = means_t[s:e]
        for h, v_h in enumerate(v_grid):
            out[s:e, h] = (blk >= v_h).sum(dim=1, dtype=torch.int32)
    return out
