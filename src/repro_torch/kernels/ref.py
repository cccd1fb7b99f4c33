"""Plain PyTorch versions of the kernels: the clustering kernels in gather
form, and banded-causal attention.

They are the CPU path (``kernels/ops.py`` sends CPU tensors here) and the
oracle ``chip_smoke.py`` holds each CUDA kernel against on the card.  None
densifies a (B, D) slab — at the NYT vocabulary that is 8 GB per 4096-row
batch — and each bounds its temporaries by walking rows in chunks.

Each function repeats its kernel's float32 arithmetic in the kernel's
order, without fused multiply-adds, so kernel and plain version agree bit
for bit where the kernel's order is fixed:

* ``sparse_sim`` / ``esicp_gather`` — every (b, k) accumulator walks the
  tuple slots p = 0..P-1 in order (``repro``'s TAAT scan order), also in
  their squared-rows and per-row-threshold variants;
* ``doc_sketch`` — every sketch slot sums its tuples' squares in p order;
* ``sketch_sim`` — every (b, k) output sums its S products in s order;
* ``esicp_filter`` — elementwise;
* ``segment_update`` — every λ entry sums its tuples in row order;
* ``rho_gather`` — lane l of a 32-lane warp sums slots l, l+32, ... and a
  butterfly folds the lanes.

``flash_attention`` is the exception: it materialises the (Sq, Sk) scores
and softmax, as ``repro/kernels/ref.py:flash_attention`` does, and so
agrees with the online-softmax kernel to a tolerance, not bit for bit.

Conventions shared with the clustering kernels: a slot is *live* iff its value is
nonzero (a dead slot, id 0 and value 0, adds nothing anywhere, counts
included); an assignment outside [0, K) selects no centroid.
"""
from __future__ import annotations

import math

import torch

# Bound on the elements of one (rows, K) temporary.
CHUNK_ELEMS = 1 << 24


def _row_chunks(n_rows: int, width: int):
    step = max(1, CHUNK_ELEMS // max(width, 1))
    for s in range(0, n_rows, step):
        yield s, min(s + step, n_rows)


def sparse_sim(ids, vals, means_t, *, with_counts: bool = False,
               square: bool = False):
    """(B, K) sims = x·μ for every pair; counts = Σ_p live·[m > 0] (int32)
    when asked, else None.

    ``square``: each gathered row is squared first (m² rounded, then v·m²),
    which is ``sparse_sim`` over the squared matrix without building it.
    """
    b, p = ids.shape
    k = means_t.shape[1]
    sims = torch.zeros((b, k), dtype=torch.float32, device=ids.device)
    counts = (torch.zeros((b, k), dtype=torch.int32, device=ids.device)
              if with_counts else None)
    for s, e in _row_chunks(b, k):
        for q in range(p):
            v = vals[s:e, q]
            m = means_t[ids[s:e, q].long()]
            sims[s:e] += v[:, None] * (m * m if square else m)
            if with_counts:
                counts[s:e] += ((m > 0) & (v != 0)[:, None]).to(torch.int32)
    return sims, counts


def esicp_gather(ids, vals, means_t, t_th, v_th, *, with_counts: bool = False,
                 v_ta=None):
    """ES gathering phase (paper Alg. 3): per (b, k)

      rho12 = Σ over the exact region (id < t_th, or m >= v_th) of v·m
      y     = Σ over id >= t_th with m < v_th of v (absent m = 0 included)
      sims  = x·μ
      counts= Σ live·[m > 0 and exact]           (int32, when asked)

    ``id`` is compared against ``t_th`` as float32, as the Pallas kernel
    does.  ``v_ta`` (B,) float32, when given, replaces the shared ``v_th``
    by a per-row threshold (TA-ICP, paper App. F-A).  Returns (rho12, y,
    sims, counts-or-None).
    """
    b, p = ids.shape
    k = means_t.shape[1]
    z = lambda dt: torch.zeros((b, k), dtype=dt, device=ids.device)
    rho12, y, sims = z(torch.float32), z(torch.float32), z(torch.float32)
    counts = z(torch.int32) if with_counts else None
    t_th = float(t_th)
    for s, e in _row_chunks(b, k):
        for q in range(p):
            v = vals[s:e, q]
            idq = ids[s:e, q]
            m = means_t[idq.long()]
            c = v[:, None] * m
            sims[s:e] += c
            tail = (idq.to(torch.float32) >= t_th)[:, None]
            thr = v_th if v_ta is None else v_ta[s:e, None]
            exact = ~tail | (m >= thr)
            rho12[s:e] += torch.where(exact, c, 0.0)
            y[s:e] += torch.where(exact, 0.0, v[:, None])
            if with_counts:
                counts[s:e] += (exact & (m > 0) & (v != 0)[:, None]).to(
                    torch.int32)
    return rho12, y, sims, counts


def esicp_filter(rho12, y, rho_max, col_ok, v_th):
    """ub = rho12 + y·v_th; mask = (ub > rho_max[b]) & col_ok (bool);
    count[b] = Σ_k mask (int32)."""
    ub = rho12 + y * v_th
    mask = (ub > rho_max[:, None]) & col_ok
    return mask, mask.sum(dim=1, dtype=torch.int32)


def segment_update(assign, ids, vals, k: int, d: int):
    """(D, K) cluster sums, transposed: λ_t[d, c] = Σ_b [assign_b = c]·x_b[d].

    Rows whose assignment lies outside [0, K) are dropped before any
    indexing (``repro``'s scatter drops them silently; ``index_add_``
    would raise).  Duplicate ids within a row add up.
    """
    lam = torch.zeros(d * k, dtype=torch.float32, device=ids.device)
    ok = (assign >= 0) & (assign < k)
    for s, e in _row_chunks(ids.shape[0], ids.shape[1]):
        sel = ok[s:e, None] & (vals[s:e] != 0)
        flat = ids[s:e].long() * k + assign[s:e].long()[:, None]
        lam.index_add_(0, flat[sel], vals[s:e][sel])
    return lam.view(d, k)


def rho_gather(assign, ids, vals, means_t, nnz=None):
    """(B,) ρ[b] = x_b · μ_{assign_b}; 0 where assign_b lies outside [0, K).

    With ``nnz`` (B,), row b reads only its slots [0, nnz[b]).  Lane l of
    a row adds its products at slots l, l+32, ... in turn, then the lanes
    fold over offsets 16, 8, 4, 2, 1 (the kernel's order)."""
    b, p = ids.shape
    k = means_t.shape[1]
    if nnz is not None:
        live = torch.arange(p, device=ids.device) < nnz[:, None]
        ids = torch.where(live, ids, 0)
        vals = torch.where(live, vals, 0.0)
    ok = (assign >= 0) & (assign < k)
    col = torch.where(ok, assign, 0).long()
    lanes = -(-p // 32) * 32
    out = torch.empty((b,), dtype=torch.float32, device=ids.device)
    for s, e in _row_chunks(b, lanes):
        prod = vals[s:e] * means_t[ids[s:e].long(), col[s:e, None]]
        prod = torch.where(ok[s:e, None] & (vals[s:e] != 0), prod, 0.0)
        prod = torch.nn.functional.pad(prod, (0, lanes - p))
        prod = prod.view(e - s, lanes // 32, 32)
        acc = torch.zeros((e - s, 32), dtype=torch.float32, device=ids.device)
        for j in range(lanes // 32):
            acc = acc + prod[:, j]
        for off in (16, 8, 4, 2, 1):
            acc = acc[:, :off] + acc[:, off:2 * off]
        out[s:e] = acc[:, 0]
    return out


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device (what the
    kernels' ``__fsqrt_rn`` and XLA give).

    torch's vectorised CPU square root misses the correctly rounded result
    for some 0.6% of inputs, float32 and float64 alike, so a kernel and its
    plain version, or the card and the CPU, would differ in the last bit.
    The float64 root rounded to float32 is at most one ulp off; it is then
    corrected with exact float64 arithmetic: the float32 neighbour whose
    rounding interval (bounded by midpoints, whose squares are exact in
    float64) holds x is kept.
    """
    y = torch.sqrt(x.double()).to(torch.float32)
    lo = torch.nextafter(y, torch.zeros_like(y))
    hi = torch.nextafter(y, torch.full_like(y, torch.inf))
    yd, xd = y.double(), x.double()
    m_lo = (lo.double() + yd) * 0.5
    m_hi = (yd + hi.double()) * 0.5
    return torch.where(xd < m_lo * m_lo, lo,
                       torch.where(xd > m_hi * m_hi, hi, y))


def doc_sketch(ids, vals, dim: int, sketch_size: int):
    """(B, S) block-vector sketch: slot s = sqrt(Σ v²) over the row's
    tuples with clip(id // g, 0, S-1) = s, g = ceil(dim / S) (as
    ``repro.core.meanindex.doc_sketch``).  Each slot adds its rounded
    squares in p order; dead slots add 0."""
    b, p = ids.shape
    g = -(-dim // sketch_size)
    seg = torch.clamp(torch.div(ids, g, rounding_mode="floor"), 0,
                      sketch_size - 1)
    slots = torch.arange(sketch_size, device=ids.device)
    acc = torch.zeros((b, sketch_size), dtype=torch.float32,
                      device=ids.device)
    for q in range(p):
        v = vals[:, q:q + 1]
        acc += torch.where(seg[:, q:q + 1] == slots, v * v, 0.0)
    return sqrt_rn(acc)


def sketch_sim(sk_docs, sketch_t):
    """(B, S) × (S, K) -> (B, K) float32, each output the s-ordered sum of
    rounded products (no fused multiply-add, no TF32)."""
    b, s_dim = sk_docs.shape
    k = sketch_t.shape[1]
    out = torch.zeros((b, k), dtype=torch.float32, device=sk_docs.device)
    for s, e in _row_chunks(b, k):
        for q in range(s_dim):
            out[s:e] += sk_docs[s:e, q:q + 1] * sketch_t[q]
    return out


def flash_attention(q, k, v, window: int = -1, sk_real: int | None = None):
    """(BH, Sq, hd) x (BH, Sk, hd) banded-causal attention, float32.

    Query and key positions both start at 0; key k_pos is live for query
    q_pos iff k_pos <= q_pos, q_pos - k_pos < window (window < 0: full
    causal) and k_pos < sk_real (default Sk).  Masked scores are -1e30, and
    a row with no live key gives 0.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    sk_real = sk if sk_real is None else sk_real
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(float(hd))
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = (kp <= qp) & (kp < sk_real)
    if window >= 0:
        mask &= (qp - kp) < window
    s = torch.where(mask[None], s, -1e30)
    probs = torch.softmax(s, dim=-1)
    probs = torch.where(mask.any(dim=1)[None, :, None], probs, 0.0)
    return torch.einsum("bqk,bkd->bqd", probs, v)
