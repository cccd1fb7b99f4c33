"""EstParams — structural-parameter estimation (paper §V, Alg. 7);
counterpart of ``repro.core.estparams``.

Minimises J(s', v_h) = φ1 + φ2 + φ̃3 over a grid of (t_th, v_th)
candidates, the approximate number of multiply-adds of the next
assignment (see ``repro.core.estparams`` for the terms).

Differences from ``repro``, all for size or determinism:

* the v_th candidates are quantiles of the positive tail-region means;
  ``repro`` calls ``jnp.nanquantile`` over the whole tail slice (about
  9.9·10^8 elements at the NYT widths), which ``torch.quantile`` refuses
  above 2^24 elements.  :func:`nanquantile` selects the positives row chunk
  by row chunk, sorts them and interpolates at q·(n−1) in float32 exactly
  as ``jnp.nanquantile`` does;
* the per-term tables loop over the 24 thresholds in row chunks instead of
  vmapping over a (D, K) temporary, in one pass over row blocks
  (:func:`_est_tables`);
* the J table is accumulated in float64, so its argmin does not depend on
  the reduction order of the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.meanindex import StructuralParams, row_chunks
from repro_torch.sparse.matrix import SparseDocs


@dataclasses.dataclass(frozen=True)
class EstGrid:
    n_v: int = 24            # |V^[th]| candidates
    n_s: int = 48            # t_th candidates
    s_min_frac: float = 0.80  # s_(min) = frac · D
    v_quantile_lo: float = 0.50
    v_quantile_hi: float = 0.999
    chunk: int = 2048        # objects per φ̃3 chunk


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32 as its CPU build computes it, so the
    candidate grids match ``repro``'s bit for bit.

    XLA rewrites start·(1−t) + stop·t with t = i/(num−1) into
    start·(1 − i·c) + i·(stop·c), c = float32(1/(num−1)), and fuses the
    last product into the add (one rounding, reproduced here in float64,
    which holds the float32 product exactly).  The endpoint is appended.
    """
    f32 = torch.float32
    start = torch.tensor(float(start), dtype=f32)
    stop = torch.tensor(float(stop), dtype=f32)
    if num == 1:
        return start.reshape(1)
    i = torch.arange(num - 1, dtype=f32)
    c = torch.tensor(1.0 / (num - 1), dtype=f32)
    head = start * (1 - i * c)
    out = (head.double() + i.double() * (stop * c).double()).to(f32)
    return torch.cat([out, stop.reshape(1)])


def nanquantile(values: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation quantiles of a 1-D float32 sample (the NaNs
    already dropped), with ``jnp.nanquantile``'s float32 arithmetic:
    position q·(n−1), weights (1−frac, frac).  An empty sample gives NaN."""
    vals, _ = torch.sort(values.to(torch.float32))
    qs = qs.to(torch.float32).to(vals.device)
    n = vals.numel()
    if n == 0:
        return torch.full_like(qs, torch.nan)
    pos = qs * torch.tensor(float(n - 1), dtype=torch.float32,
                            device=vals.device)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo = torch.clamp(low, 0, n - 1).long()
    hi = torch.clamp(high, 0, n - 1).long()
    # jnp computes low·lw + high·hw with the second product fused into the
    # add (one rounding); float64 holds the float32 product exactly, so the
    # sum below rounds once, the same way.
    low_part = (vals[lo] * lw).double()
    return (low_part + vals[hi].double() * hw.double()).to(torch.float32)


def table_row_blocks(d: int, k: int, grid: EstGrid) -> list:
    """The (start, end) row blocks of the (D, K) means that the tables
    read, in order: the positive tail's rows [s_min, D), then every row.
    A mesh whose means are split by columns gathers each block whole to
    one rank, so the sums over K run on the same (rows, K) blocks as on
    one device."""
    s_min = int(grid.s_min_frac * d)
    return ([(s_min + s, s_min + e) for s, e in row_chunks(d - s_min, k)]
            + list(row_chunks(d, k)))


def _v_candidates(positives: torch.Tensor, grid: EstGrid) -> list[float]:
    qs = linspace_f32(grid.v_quantile_lo, grid.v_quantile_hi, grid.n_v)
    cand = nanquantile(positives, qs)
    cand = torch.where(torch.isnan(cand), 1.0, cand)   # degenerate -> vacuous
    return torch.clamp(cand, min=1e-6).tolist()


def _est_tables(df: torch.Tensor, d: int, k: int, block, grid: EstGrid):
    """Candidate grids, φ1/φ2, and the per-term tables φ̃3 consumes.

    ``block(s, e)`` is rows [s, e) of the (D, K) means, asked for in
    :func:`table_row_blocks`' order: the positives of the tail rows
    [s_min, D) (sorted next, so their order is irrelevant) pick the v_th
    candidates; then one pass over every row counts mf and (mfH)_{s,h}
    and sums Δv̄ (Eq. 39: relu(v_h − v) in float32, summed in float64
    over K, absent centroids counted) and Σ_k v_{s,k} (Eq. 32).
    """
    dev = df.device
    s_min = int(grid.s_min_frac * d)
    blocks = table_row_blocks(d, k, grid)
    n_tail = len(blocks) - len(list(row_chunks(d, k)))
    parts = []
    for s, e in blocks[:n_tail]:
        blk = block(s, e)
        parts.append(blk[blk > 0])
    positives = torch.cat(parts) if parts else torch.zeros((0,), device=dev)
    del parts
    s_grid = torch.unique(
        linspace_f32(s_min, d, grid.n_s).to(torch.int32)).to(dev)
    v_grid = _v_candidates(positives, grid)
    del positives

    h = len(v_grid)
    mf = torch.empty((d,), dtype=torch.float64, device=dev)
    mfh = torch.empty((d, h), dtype=torch.int32, device=dev)
    dvbar = torch.empty((d, h), dtype=torch.float64, device=dev)
    colsum = torch.empty((d,), dtype=torch.float64, device=dev)
    for s, e in blocks[n_tail:]:
        blk = block(s, e)
        mf[s:e] = (blk > 0).sum(dim=1)
        for j, v_h in enumerate(v_grid):
            mfh[s:e, j] = (blk >= v_h).sum(dim=1, dtype=torch.int32)
            dvbar[s:e, j] = torch.clamp(v_h - blk, min=0.0).double().sum(
                dim=1)
        colsum[s:e] = blk.double().sum(dim=1)
    dvbar /= k
    dff = df.to(dev, torch.float64)

    c1 = torch.cat([dff.new_zeros((1,)), torch.cumsum(dff * mf, dim=0)])
    phi1 = c1[s_grid.long()]                                # (S',)

    sfx = torch.flip(torch.cumsum(torch.flip(dff[:, None] * mfh.double(),
                                             [0]), dim=0), [0])
    sfx = torch.cat([sfx, sfx.new_zeros((1, h))], dim=0)
    phi2 = sfx[s_grid.long()]                               # (S', H)
    return s_grid, v_grid, phi1, phi2, dvbar, colsum


def _phi3_chunk(ids, vals, nnz, dvbar, colsum, rho_a, s_grid, *, k: int):
    """φ̃3 contribution of one object chunk -> (S', H) float64."""
    c, p = ids.shape
    h = dvbar.shape[1]
    live = torch.arange(p, device=ids.device)[None, :] < nnz[:, None]
    u = torch.where(live, vals, 0.0).double()
    idl = ids.long()

    w = u[:, :, None] * dvbar[idl]                          # (C, P, H)
    w = torch.where(live[:, :, None], w, 0.0)
    suf = torch.flip(torch.cumsum(torch.flip(w, [1]), dim=1), [1])
    suf = torch.cat([suf, suf.new_zeros((c, 1, h))], dim=1)

    rho_bar = (u * colsum[idl]).sum(dim=1) / k              # Eq. 32
    denom = torch.clamp(rho_a.double() - rho_bar, min=1e-9)

    # p* = first tuple position with id >= s' (ids ascend within a row)
    pstar = (live[:, :, None] & (ids[:, :, None] < s_grid[None, None, :])
             ).sum(dim=1)                                   # (C, S')
    nt_h = (nnz[:, None] - pstar).double()

    dr = torch.gather(suf, 1, pstar[:, :, None].expand(-1, -1, h))
    x = dr / denom[:, None, None]
    log_ke = math.log(k / math.e)
    factor = torch.clamp(torch.exp(x * log_ke), max=float(k))
    return (nt_h[:, :, None] * factor).sum(dim=0)


def _phi3(docs: SparseDocs, rho_self: torch.Tensor, tables, *, k: int,
          grid: EstGrid) -> torch.Tensor:
    """φ̃3 (S', H) float64 of ``docs``' rows, summed over slices of
    ``grid.chunk`` rows from the first."""
    s_grid, v_grid, _, _, dvbar, colsum = tables
    phi3 = torch.zeros((len(s_grid), len(v_grid)), dtype=torch.float64,
                       device=dvbar.device)
    for start in range(0, docs.n_docs, grid.chunk):
        end = min(start + grid.chunk, docs.n_docs)
        phi3 += _phi3_chunk(docs.ids[start:end], docs.vals[start:end],
                            docs.nnz[start:end], dvbar, colsum,
                            rho_self[start:end], s_grid, k=k)
    return phi3


def _est_minimize(s_grid, v_grid, phi1, phi2, phi3):
    j_table = phi1[:, None] + phi2 + phi3
    flat = int(torch.argmin(j_table))
    si, hi = divmod(flat, j_table.shape[1])
    params = StructuralParams(t_th=int(s_grid[si]), v_th=v_grid[hi])
    aux = {"J": j_table, "s_grid": s_grid, "v_grid": v_grid,
           "phi1": phi1, "phi2": phi2, "phi3": phi3}
    return params, aux


def estimate_params(docs: SparseDocs, df: torch.Tensor,
                    means_t: torch.Tensor, rho_self: torch.Tensor, *, k: int,
                    grid: EstGrid = EstGrid()):
    """Returns the minimising StructuralParams and an aux dict (J table).

    rho_self: (N,) ρ_{a(i)} against the current means — the update step's
    refreshed self-similarities, what Alg. 7 consumes.
    """
    tables = _est_tables(df.to(means_t.device), *means_t.shape,
                         lambda s, e: means_t[s:e], grid)
    return _est_minimize(*tables[:4], _phi3(docs, rho_self, tables, k=k,
                                            grid=grid))


def estimate_params_store(store, df: torch.Tensor, means_t: torch.Tensor,
                          rho_self: torch.Tensor, *, k: int,
                          grid: EstGrid = EstGrid(), prefetch_depth: int = 2):
    """:func:`estimate_params` over a
    :class:`repro_torch.sparse.store.DocStore`, the chunks streamed to the
    means' device.

    rho_self: (store.n_rows,) — the streaming fit's ρ (dead rows 0).  φ̃3
    sums the real rows only, in the resident estimate's ``grid.chunk``
    slices of the global row range: a slice that spans two store chunks
    takes the tail of one and the head of the next.  So the estimate is the
    resident one bit for bit, whatever the chunk size.
    """
    from repro_torch.sparse.store import ChunkPrefetcher

    s_grid, v_grid, phi1, phi2, dvbar, colsum = _est_tables(
        df.to(means_t.device), *means_t.shape, lambda s, e: means_t[s:e],
        grid)
    phi3 = torch.zeros((len(s_grid), len(v_grid)), dtype=torch.float64,
                       device=means_t.device)
    c = store.chunk_size
    carry = None                 # rows of a slice begun in an earlier chunk
    for ci, cdocs in ChunkPrefetcher(store, depth=prefetch_depth,
                                     device=means_t.device):
        m = store.n_valid(ci)
        part = (cdocs.ids[:m], cdocs.vals[:m], cdocs.nnz[:m],
                rho_self[ci * c:ci * c + m])
        if carry is not None:
            part = tuple(torch.cat([a, b]) for a, b in zip(carry, part))
        n = part[0].shape[0]
        full = n - n % grid.chunk if ci < store.n_chunks - 1 else n
        for start in range(0, full, grid.chunk):
            end = min(start + grid.chunk, full)
            phi3 += _phi3_chunk(*(a[start:end] for a in part[:3]), dvbar,
                                colsum, part[3][start:end], s_grid, k=k)
        carry = tuple(a[full:] for a in part) if full < n else None
    return _est_minimize(s_grid, v_grid, phi1, phi2, phi3)

