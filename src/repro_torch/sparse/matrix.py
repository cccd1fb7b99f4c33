"""Sparse document matrix: fixed-width padded (ids, vals) rows, in torch.

Counterpart of ``repro.sparse.matrix``.  Each document is a padded list of
(term id, feature value) tuples: ``ids (N, P) int32`` ascending within a
row, ``vals (N, P) float32`` with ``0.0`` on padding, ``nnz (N,) int32``
live tuples per row.  Padding uses term id 0 with value 0, so every gather
stays in bounds and every product contributes nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class SparseDocs:
    """N documents as padded (term id, value) tuple rows.

    ids:  (N, P) int32, ascending within a row (df-rank order once
          :func:`remap_terms_by_df` has run); 0 on padding.
    vals: (N, P) float32, 0.0 on padding.
    nnz:  (N,) int32, live tuples per row.
    dim:  vocabulary size D.
    _df:  optional (D,) int32 document frequencies (the corpus builders
          attach them with :func:`with_df`); read through ``df``.

    The tensors are not changed in place after construction: ``by_term``
    is derived from them once and kept.
    """

    ids: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    dim: int
    _df: torch.Tensor | None = None

    @property
    def n_docs(self) -> int:
        return self.ids.shape[0]

    @property
    def pad_width(self) -> int:
        return self.ids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.ids.device

    def row_mask(self) -> torch.Tensor:
        """(N, P) bool — True on live tuples."""
        p = torch.arange(self.pad_width, device=self.device)
        return p[None, :] < self.nnz[:, None]

    def live_vals(self) -> torch.Tensor:
        """(N, P) values with every slot past a row's nnz set to 0."""
        return torch.where(self.row_mask(), self.vals, 0.0)

    @functools.cached_property
    def by_term(self) -> TermMajor:
        """The live tuples term-major (:func:`term_major`), built on first
        use and kept: the update's ``segment_update`` kernel walks it at
        every Lloyd iteration, and the documents never change."""
        return term_major(self.ids, self.live_vals(), d=self.dim)

    @property
    def df(self) -> torch.Tensor:
        """(D,) document frequency of each term (counted when not attached)."""
        return self._df if self._df is not None else df_counts(self)

    def slice_rows(self, start: int, size: int) -> SparseDocs:
        """Rows [start, start+size) as views; the corpus df is not carried
        (a row subset has its own document frequencies)."""
        end = min(start + size, self.n_docs)
        return SparseDocs(self.ids[start:end], self.vals[start:end],
                          self.nnz[start:end], self.dim)

    def to(self, device) -> SparseDocs:
        """These documents on ``device``: self when they are there already
        (``"cuda"`` names the current card), so ``by_term`` is kept."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self.device == dev:
            return self
        mv = lambda t: None if t is None else t.to(dev)
        return SparseDocs(mv(self.ids), mv(self.vals), mv(self.nnz), self.dim,
                          mv(self._df))

    def validate(self) -> SparseDocs:
        """Check dtypes, shapes and the id range once at an entry point, so
        the kernels never see an out-of-range term id.  Returns self."""
        if self.ids.dtype != torch.int32 or self.nnz.dtype != torch.int32:
            raise TypeError("ids and nnz must be int32")
        if self.vals.dtype != torch.float32:
            raise TypeError("vals must be float32")
        if self.ids.shape != self.vals.shape or self.ids.ndim != 2:
            raise ValueError(f"ids {tuple(self.ids.shape)} and vals "
                             f"{tuple(self.vals.shape)} must be one (N, P)")
        if self.nnz.shape != (self.n_docs,):
            raise ValueError("nnz must be (N,)")
        if self.ids.numel():
            lo, hi = torch.aminmax(self.ids)
            if int(lo) < 0 or int(hi) >= self.dim:
                raise ValueError(f"term ids must lie in [0, {self.dim})")
        return self


class TermMajor(NamedTuple):
    """Tuples term-major (see :func:`term_major`).

    ptr:   (D + 1,) int64 — term d's postings are [ptr[d], ptr[d + 1]).
    rows:  (nnz,) int32 — each posting's document row.
    vals:  (nnz,) float32 — each posting's value (never 0).
    order: (D,) int32 — the terms by posting count, longest first.
    """

    ptr: torch.Tensor
    rows: torch.Tensor
    vals: torch.Tensor
    order: torch.Tensor


def term_major(ids: torch.Tensor, vals: torch.Tensor, *, d: int
               ) -> TermMajor:
    """The term-major layout of (N, P) tuple rows over D terms.

    Slots whose value is 0 (padding, masked tuples) are dropped; within a
    term the postings keep (row, slot) order, so duplicate ids within a
    row stay in slot order.  Built with one stable sort of the row-major
    flattened ids, on the tuples' device.  Memory: nnz·8 bytes, plus
    8·(D + 1) + 4·D.
    """
    n, _ = ids.shape
    live = vals != 0
    rows = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=ids.device), live.sum(dim=1))
    flat_ids = ids[live]
    _, perm = torch.sort(flat_ids, stable=True)
    counts = torch.bincount(flat_ids.long(), minlength=d)
    ptr = torch.zeros((d + 1,), dtype=torch.int64, device=ids.device)
    torch.cumsum(counts, dim=0, out=ptr[1:])
    order = torch.argsort(counts, descending=True, stable=True)
    return TermMajor(ptr, rows[perm].contiguous(),
                     vals[live][perm].contiguous(), order.to(torch.int32))


def from_dense(x, pad_to: int | None = None, *, device="cuda") -> SparseDocs:
    """Dense (N, D) -> SparseDocs (host build, ascending ids)."""
    dev = resolve_device(device)
    x = np.asarray(x)
    n, d = x.shape
    nnz = (x != 0).sum(axis=1).astype(np.int32)
    p = int(pad_to if pad_to is not None else max(int(nnz.max(initial=1)), 1))
    ids = np.zeros((n, p), np.int32)
    vals = np.zeros((n, p), np.float32)
    for i in range(n):
        (cols,) = np.nonzero(x[i])
        cols = cols[:p]
        ids[i, :len(cols)] = cols
        vals[i, :len(cols)] = x[i, cols]
    nnz = np.minimum(nnz, p)
    return SparseDocs(torch.from_numpy(ids).to(dev),
                      torch.from_numpy(vals).to(dev),
                      torch.from_numpy(nnz).to(dev), d)


def to_dense(docs: SparseDocs) -> torch.Tensor:
    """(N, D) dense reconstruction — for tests at small sizes only."""
    n, p = docs.ids.shape
    out = torch.zeros((n, docs.dim), dtype=docs.vals.dtype, device=docs.device)
    rows = torch.arange(n, device=docs.device).repeat_interleave(p)
    vals = docs.live_vals().reshape(-1)
    out.index_put_((rows, docs.ids.reshape(-1).long()), vals, accumulate=True)
    return out


def with_df(docs: SparseDocs, df: torch.Tensor) -> SparseDocs:
    """Attach document frequencies the caller already holds."""
    return dataclasses.replace(docs, _df=df.to(docs.device, torch.int32))


def df_counts(docs: SparseDocs) -> torch.Tensor:
    """(D,) int32 document frequency of each term."""
    flat = torch.where(docs.row_mask(), docs.ids, docs.dim).reshape(-1)
    return torch.bincount(flat.long(), minlength=docs.dim + 1)[:docs.dim].to(
        torch.int32)


def tf_idf(docs: SparseDocs, df: torch.Tensor | None = None,
           n_total: int | None = None) -> SparseDocs:
    """Classic tf-idf re-weighting (paper Eq. 15): tf * log(N / df_s)."""
    if df is None:
        df = docs.df
    n = float(n_total if n_total is not None else docs.n_docs)
    dff = torch.clamp(df.to(torch.float32), min=1.0)
    # A true float32 division (``n / tensor`` would multiply by a reciprocal).
    idf = torch.log(torch.full_like(dff, n) / dff)
    vals = docs.vals * idf[docs.ids.long()]
    vals = torch.where(docs.row_mask(), vals, 0.0)
    return dataclasses.replace(docs, vals=vals)


def l2_normalize_rows(docs: SparseDocs, eps: float = 1e-12) -> SparseDocs:
    """Project each document onto the unit hypersphere."""
    norm = torch.sqrt(torch.sum(docs.vals * docs.vals, dim=1) + eps)
    return dataclasses.replace(docs, vals=docs.vals / norm[:, None])


def remap_terms_by_df(docs: SparseDocs, df: torch.Tensor | None = None):
    """Permute term ids into ascending-df rank order (paper Table I).

    Returns (docs', perm) with ``perm[new_id] = old_id``; term ``D-1`` is the
    highest-df term.  Tuples are re-sorted ascending by new id, so the
    ``s >= t_th`` tail of each row is a contiguous suffix.
    """
    if df is None:
        df = docs.df
    perm = torch.argsort(df, stable=True)               # perm[new] = old
    inv = torch.argsort(perm, stable=True)              # inv[old] = new
    new_ids = inv[docs.ids.long()]
    live = docs.row_mask()
    sort_key = torch.where(live, new_ids, docs.dim)
    order = torch.argsort(sort_key, dim=1, stable=True)
    new_ids = torch.gather(torch.where(live, new_ids, 0), 1, order)
    new_vals = torch.gather(torch.where(live, docs.vals, 0.0), 1, order)
    docs2 = dataclasses.replace(docs, ids=new_ids.to(torch.int32),
                                vals=new_vals, _df=df[perm].to(torch.int32))
    return docs2, perm


def pad_rows(docs: SparseDocs, multiple: int) -> SparseDocs:
    """Pad N up to a multiple with dead rows (nnz = 0, vals = 0)."""
    pad = (-docs.n_docs) % multiple
    if pad == 0:
        return docs
    zpad = lambda t: torch.cat(
        [t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=t.device)])
    return SparseDocs(zpad(docs.ids), zpad(docs.vals), zpad(docs.nnz),
                      docs.dim, docs._df)


def l1_tail(docs: SparseDocs, t_th: int) -> torch.Tensor:
    """(N,) float32 partial L1 norm of each row over its live tuples with
    term id >= t_th (the paper's initial y)."""
    tail = (docs.ids >= t_th) & docs.row_mask()
    return torch.where(tail, docs.vals, 0.0).sum(dim=1)
