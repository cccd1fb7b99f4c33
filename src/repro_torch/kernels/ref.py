"""Plain PyTorch versions of the kernels: the clustering kernels in gather
form, banded-causal attention and the sLSTM scan.

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
* ``segment_update`` — every λ entry sums its tuples in row order (from
  +0, or onto ``init``);
* ``routed_scan`` — every candidate walks the row's live slots in order,
  as ``sparse_sim`` does for its column;
* ``rho_gather`` — each row sums its products in :func:`window_sum`'s
  order over its full padded width (``repro``'s float32 order); a row of
  at most 32 slots in :func:`short_row_sum`'s order of fused
  multiply-adds, which the kernel takes with ``__fmaf_rn``;
* ``slstm_scan`` — a Python loop over time, each step in the kernel's
  order of rounded elementwise operations.

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


def routed_scan(ids, vals, nnz, means_t, cells, starts, sizes, cmax: int):
    """Two-level routed classify of a batch -> (assign (B,) int32, best
    (B,) float32, scored (B,) int32).

    Candidate j = r·cmax + s of row b is column starts[c] + s of cell
    c = cells[b, r] when s < sizes[c], else a dead slot at -inf.  Each
    live candidate sums v·m over the row's slots [0, nnz[b]) in order;
    ``assign`` is the first maximum's column (probe rank major, then
    slot), ``scored`` K_c + Σ_r sizes[cells[b, r]].
    """
    b, p = ids.shape
    slot = torch.arange(cmax, device=ids.device)
    cl = cells.long()
    psize = sizes[cl]
    valid = (slot < psize[:, :, None]).reshape(b, -1)
    cols = torch.where(valid, (starts[cl][:, :, None] + slot).reshape(b, -1),
                       0).long()
    sims = torch.zeros(cols.shape, dtype=torch.float32, device=ids.device)
    for s, e in _row_chunks(b, cols.shape[1]):
        n = nnz[s:e]
        for q in range(min(int(n.max()), p)):
            live = q < n
            v = torch.where(live, vals[s:e, q], 0.0)
            i = torch.where(live, ids[s:e, q], 0).long()
            sims[s:e] += v[:, None] * means_t[i[:, None], cols[s:e]]
    sims = torch.where(valid, sims, -torch.inf)
    j = torch.argmax(sims, dim=1, keepdim=True)
    return (cols.gather(1, j)[:, 0].to(torch.int32), sims.gather(1, j)[:, 0],
            (starts.shape[0] + psize.sum(dim=1)).to(torch.int32))


def esicp_filter(rho12, y, rho_max, col_ok, v_th):
    """ub = rho12 + y·v_th; mask = (ub > rho_max[b]) & col_ok (bool);
    count[b] = Σ_k mask (int32)."""
    ub = rho12 + y * v_th
    mask = (ub > rho_max[:, None]) & col_ok
    return mask, mask.sum(dim=1, dtype=torch.int32)


def segment_update(assign, ids, vals, k: int, d: int, init=None):
    """(D, K) cluster sums, transposed: λ_t[d, c] = Σ_b [assign_b = c]·x_b[d].

    Rows whose assignment lies outside [0, K) are dropped before any
    indexing (``repro``'s scatter drops them silently; ``index_add_``
    would raise).  Duplicate ids within a row add up.  ``init`` (D, K),
    contiguous, is added to in place and returned.
    """
    lam = (torch.zeros(d * k, dtype=torch.float32, device=ids.device)
           if init is None else init.view(-1))
    ok = (assign >= 0) & (assign < k)
    for s, e in _row_chunks(ids.shape[0], ids.shape[1]):
        sel = ok[s:e, None] & (vals[s:e] != 0)
        flat = ids[s:e].long() * k + assign[s:e].long()[:, None]
        lam.index_add_(0, flat[sel], vals[s:e][sel])
    return lam.view(d, k)


def rho_gather(assign, ids, vals, means_t, nnz):
    """(B,) ρ[b] = x_b · μ_{assign_b}; 0 where assign_b lies outside [0, K).

    Row b reads only its slots [0, nnz[b]) (a row whose slots are all live
    passes nnz = P); a slot adds v·μ[id, assign_b] when v != 0 and id lies
    in [0, D).  Each row's products, +0 at every other slot of its padded
    width P, are summed in :func:`window_sum`'s order (P > 32) or
    :func:`short_row_sum`'s (P <= 32): ``repro``'s
    ``jnp.sum(vals * picked, axis=1)`` bit for bit.  The order depends on
    P (and K) alone, and the +0 slots change no partial sum."""
    b, p = ids.shape
    d, k = means_t.shape
    out = torch.zeros((b,), dtype=torch.float32, device=ids.device)
    if p == 0:
        return out
    ok = (assign >= 0) & (assign < k)
    col = torch.where(ok, assign, 0).long()
    slots = torch.arange(p, device=ids.device)
    for s, e in _row_chunks(b, p):
        i = ids[s:e]
        live = ((slots < nnz[s:e, None]) & ok[s:e, None] & (vals[s:e] != 0)
                & (i >= 0) & (i < d))
        m = means_t[torch.where(live, i, 0).long(), col[s:e, None]]
        v = torch.where(live, vals[s:e], 0.0)
        if p <= WINDOW:
            out[s:e] = short_row_sum(v, torch.where(live, m, 0.0), k)
        else:
            out[s:e] = window_sum((v * m).t())
    return out


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact float32 fused multiply-add RN(a·b + c) on any device (what
    ``__fmaf_rn`` and XLA's contracted multiply-adds give).

    The float64 product of two float32 values is exact; the float64 sum
    is rounded to odd (its TwoSum error, where non-zero, moves an even
    result one ulp towards the exact sum), which makes the final rounding
    to float32 correct: a plain float64 sum would round twice.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    to = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, to),
                       s).to(torch.float32)


def short_row_stages(p: int, k: int) -> tuple:
    """((lanes, slots), ...) of XLA's CPU loop for ``repro``'s ρ over
    rows of ``p`` <= 32 slots against ``k`` centroids (see
    :func:`short_row_sum`)."""
    if p <= 18 or (k == 1 and p <= 21):
        return ()
    if p == 19:
        return ((8, 16), (2, 2))
    if p <= 23:
        return ((4, 16), (4, 4))
    return ((8, p // 8 * 8),)


def short_row_sum(v: torch.Tensor, m: torch.Tensor, k: int) -> torch.Tensor:
    """(B, P <= 32) -> (B,) Σ_j v_j·m_j in ``repro``'s float32 order.

    XLA's CPU compiler contracts each product into its add, and its loop
    vectoriser picks the order by P (and K, for 19-21 slots): per stage of
    :func:`short_row_stages`, ``lanes`` accumulators start at 0 (the
    running sum in lane 0 after the first stage), slot j goes to lane
    j mod lanes, and the lanes are folded by halving (lane i += lane
    i + lanes/2, down to one); the slots after the stages are added one by
    one.  Every step is a fused multiply-add (:func:`fma_rn`), every fold
    a float32 add.
    """
    n, p = v.shape
    acc = torch.zeros((n,), dtype=torch.float32, device=v.device)
    pos = 0
    for lanes, count in short_row_stages(p, k):
        lane = [acc] + [torch.zeros_like(acc) for _ in range(lanes - 1)]
        for j in range(count):
            lane[j % lanes] = fma_rn(v[:, pos + j], m[:, pos + j],
                                     lane[j % lanes])
        while len(lane) > 1:
            h = len(lane) // 2
            lane = [lane[i] + lane[i + h] for i in range(h)]
        acc, pos = lane[0], pos + count
    for j in range(pos, p):
        acc = fma_rn(v[:, j], m[:, j], acc)
    return acc


# Width of one window of ``repro``'s CPU reductions (see window_sum).
WINDOW = 32


def _sequential_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ along ``dim`` as acc = 0; acc = acc + x[j] for j in order."""
    acc = torch.zeros_like(x.select(dim, 0))
    for j in range(x.shape[dim]):
        acc = acc + x.select(dim, j)
    return acc


def _window_level(x: torch.Tensor) -> torch.Tensor:
    """One level of the tree: zero-pad dim 0 to a WINDOW multiple (half the
    padding in front), then sum each window of WINDOW rows in order."""
    n = x.shape[0]
    pad = -n % WINDOW
    x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
    return _sequential_sum(x.reshape(-1, WINDOW, x.shape[1]), 1)


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, M) -> (M,) float32 sums over dim 0 in ``repro``'s order.

    XLA's CPU compiler rewrites a float32 reduction longer than WINDOW into
    window levels (:func:`_window_level`) until at most WINDOW partials
    remain, which it adds in order.  Repeating that order makes these sums
    equal ``repro``'s bit for bit, on the CPU and on the card alike (the
    adds are elementwise, so the device's own reduction order never
    enters).
    """
    while x.shape[0] > WINDOW:
        x = _window_level(x)
    return _sequential_sum(x, 0)


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


def band_mask(sq: int, sk: int, window: int, sk_real: int, device):
    """(Sq, Sk) bool: key k_pos is live for query q_pos iff k_pos <= q_pos,
    q_pos - k_pos < window (window < 0: full causal) and k_pos < sk_real."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = (kp <= qp) & (kp < sk_real)
    if window >= 0:
        mask &= (qp - kp) < window
    return mask


def flash_attention(q, k, v, window: int = -1, sk_real: int | None = None, *,
                    with_lse: bool = False):
    """(BH, Sq, hd) x (BH, Sk, hd) banded-causal attention, float32.

    Query and key positions both start at 0; key k_pos is live for query
    q_pos iff k_pos <= q_pos, q_pos - k_pos < window (window < 0: full
    causal) and k_pos < sk_real (default Sk).  Masked scores are -1e30, and
    a row with no live key gives 0.  ``with_lse``: also each row's
    log-sum-exp of its scaled scores (BH, Sq), +inf on a row with no live
    key, what the backward recomputes the probabilities from.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    sk_real = sk if sk_real is None else sk_real
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(float(hd))
    mask = band_mask(sq, sk, window, sk_real, q.device)
    s = torch.where(mask[None], s, -1e30)
    probs = torch.softmax(s, dim=-1)
    row_live = mask.any(dim=1)[None, :]
    probs = torch.where(row_live[..., None], probs, 0.0)
    out = torch.einsum("bqk,bkd->bqd", probs, v)
    if not with_lse:
        return out
    return out, torch.where(row_live, torch.logsumexp(s, dim=-1), torch.inf)


def flash_attention_bwd(q, k, v, lse, do, window: int = -1,
                        sk_real: int | None = None):
    """The gradient of :func:`flash_attention` at (q, k, v) for the
    output's adjoint ``do``, from the forward's ``lse`` -> (dq, dk, dv),
    float32.  With s the scaled scores, over the live pairs only:

        P~ = exp(s - lse);  Z = rowsum(P~);  P = P~ / Z;  dP = do·vᵀ
        D = rowsum(P ∘ dP);  dS = P ∘ (dP - D)
        dv = Pᵀ·do;  dk = dSᵀ·q / sqrt(hd);  dq = dS·k / sqrt(hd)

    so a row with no live key and a key at or past ``sk_real`` get 0.  Z
    is 1 and D is rowsum(do ∘ o) but for rounding; summed from the same P
    and dP as dS, their rounding cancels as in the softmax's own backward
    (``csrc/flash_attention_bwd.cu`` does the same)."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    sk_real = sk if sk_real is None else sk_real
    root = math.sqrt(float(hd))
    s = torch.einsum("bqd,bkd->bqk", q, k) / root
    mask = band_mask(sq, sk, window, sk_real, q.device)
    p = torch.where(mask[None], torch.exp(s - lse[..., None]), 0.0)
    z = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(z > 0, z, 1.0)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, k) / root
    dk = torch.einsum("bqk,bqd->bkd", ds, q) / root
    return dq, dk, dv


def slstm_scan(gates, c0, n0, m0):
    """The sLSTM recurrence over t = 0..S-1 of gates (B, S, 4D) float32,
    laid out z | i | f | o, from the state (c0, n0, m0) (B, D) ->
    (hs (B, S, D), c, n, m), ``repro``'s ``slstm_block`` ``step``:

        m' = max(f + m, i);  i_e = exp(i - m');  f_e = exp(f + m - m')
        c = f_e·c + i_e·tanh(z);  n = f_e·n + i_e
        h = sigmoid(o)·c / max(n, 1)

    The sigmoid is written out as 1 / (1 + exp(-o)), the form the kernel
    repeats, so neither depends on how torch computes its own sigmoid."""
    b, s, d4 = gates.shape
    z, i, f, o = gates.split(d4 // 4, dim=-1)
    # max against a 1, not clamp: on a tie n == 1 autograd then splits the
    # gradient as JAX's jnp.maximum does (step 0 of every prefill ties, but
    # there the weight cancels; a step from a cached state need not)
    one = torch.ones((), dtype=torch.float32, device=gates.device)
    c, n, m = c0, n0, m0
    hs = torch.empty((b, s, d4 // 4), dtype=torch.float32, device=gates.device)
    for t in range(s):
        fm = f[:, t] + m
        m_new = torch.maximum(fm, i[:, t])
        i_e = torch.exp(i[:, t] - m_new)
        f_e = torch.exp(fm - m_new)
        c = f_e * c + i_e * torch.tanh(z[:, t])
        n = f_e * n + i_e
        sig = torch.reciprocal(1.0 + torch.exp(-o[:, t]))
        hs[:, t] = sig * c / torch.maximum(n, one)
        m = m_new
    return hs, c.clone(), n.clone(), m.clone()


def max_weight(a, b):
    """The share of max(a, b)'s gradient that goes to a under JAX's rule
    (``jnp.maximum``, which ``repro`` differentiates): 1 if a > b, 1/2 on a
    tie, 0 below."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def slstm_scan_bwd(gates, c0, n0, m0, dhs, dc, dn, dm):
    """The gradient of :func:`slstm_scan` from the state (c0, n0, m0) for
    the adjoints dhs (B, S, D) of hs and dc, dn, dm (B, D) of the final
    state -> (dgates (B, S, 4D), dc0, dn0, dm0), float32.

    The forward runs again, keeping the state after every step; then, from
    t = S - 1 down to 0, with (c, n, m) the state before step t and (c',
    n', m') after it, w = :func:`max_weight`:

        fm = f + m;  ie = exp(i - m');  fe = exp(fm - m');  u = tanh(z)
        sig = 1 / (1 + exp(-o));  den = max(n', 1);  h = sig·c' / den
        gq = gh / den;  go = (gq·c')·sig·(1 - sig)
        gc' += gq·sig;  gn' -= (gq·h)·w(n', 1)
        gfe = gc'·c + gn'·n;  gie = gc'·u + gn';  gu = gc'·ie
        gz = (gu + gu·u)·(1 - u)             (jax's rule for tanh)
        ga = gfe·fe;  gb = gie·ie;  gm' = gm' - ga - gb
        gi = gb + gm'·w(i, fm);  gf = gm = ga + gm'·w(fm, i)
        gc = gc'·fe;  gn = gn'·fe

    ``csrc/slstm_scan_bwd.cu`` repeats these operations in this order."""
    b, s, d4 = gates.shape
    d = d4 // 4
    z, i, f, o = gates.split(d, dim=-1)
    one = torch.ones((), dtype=torch.float32, device=gates.device)
    states = [(c0, n0, m0)]
    c, n, m = c0, n0, m0
    for t in range(s):
        fm = f[:, t] + m
        m = torch.maximum(fm, i[:, t])
        i_e = torch.exp(i[:, t] - m)
        f_e = torch.exp(fm - m)
        c = f_e * c + i_e * torch.tanh(z[:, t])
        n = f_e * n + i_e
        states.append((c, n, m))
    dgates = torch.empty_like(gates)
    gc, gn, gm = dc, dn, dm
    for t in reversed(range(s)):
        cp, np_, mp = states[t]
        c1, n1, m1 = states[t + 1]
        zt, it, ft, ot = z[:, t], i[:, t], f[:, t], o[:, t]
        fm = ft + mp
        ie = torch.exp(it - m1)
        fe = torch.exp(fm - m1)
        u = torch.tanh(zt)
        sig = torch.reciprocal(1.0 + torch.exp(-ot))
        den = torch.maximum(n1, one)
        h = sig * c1 / den
        gq = dhs[:, t] / den
        go = gq * c1 * sig * (1.0 - sig)
        gc1 = gc + gq * sig
        gn1 = gn - gq * h * max_weight(n1, one)
        gfe = gc1 * cp + gn1 * np_
        gie = gc1 * u + gn1
        gu = gc1 * ie
        gz = (gu + gu * u) * (1.0 - u)
        ga = gfe * fe
        gb = gie * ie
        gm1 = gm - ga - gb
        gi = gb + gm1 * max_weight(it, fm)
        gfm = ga + gm1 * max_weight(fm, it)
        dgates[:, t, :d] = gz
        dgates[:, t, d:2 * d] = gi
        dgates[:, t, 2 * d:3 * d] = gfm
        dgates[:, t, 3 * d:] = go
        gc, gn, gm = gc1 * fe, gn1 * fe, gfm
    return dgates, gc, gn, gm
