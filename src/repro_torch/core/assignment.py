"""Assignment step (counterpart of ``repro.core.assignment``): the nine
algorithm modes.

Each mode is selection logic over accumulators from the kernel backend
(:class:`repro_torch.core.backends.KernelBackend`).

Exactness: every algorithm returns the same assignments as MIVI from the
same state; the filters change only Mult and |Z_i|, counted as the paper
counts them (the multiply-adds a CPU implementation would execute), and
the maintained per-group bounds ``ub`` of the bounds modes.  Tie rule
(``repro``'s ``_finalize``): a centroid must strictly beat ρ_self, and
among equal best scores the lowest centroid id wins (``torch.argmax``
returns the first maximum).  Mult is an exact int64 count (``repro`` sums
float32, which agrees below 2^24).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.backends import col_ok_mask
from repro_torch.core.meanindex import MeanIndex, doc_sketch, region3_sketch
from repro_torch.core.update import n_ub_groups, ub_group_of, ub_group_size
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sqrt_rn
from repro_torch.sparse.matrix import SparseDocs


@dataclasses.dataclass(frozen=True)
class AssignResult:
    assign: torch.Tensor        # (B,) int32 — new a(i)
    rho: torch.Tensor           # (B,) float32 — similarity to the winner
    n_candidates: torch.Tensor  # (B,) int32 — |Z_i|
    mult: torch.Tensor          # () int64 — multiply-adds the CPU algo executes
    changed: torch.Tensor       # (B,) bool
    ub: torch.Tensor            # (B, G) float32 — refreshed per-group upper
    #                             bounds on the best non-assigned similarity
    #                             (bounds modes; the others pass theirs through)


def _finalize(sims_masked, prev_assign, rho_self):
    """Sequential 'if ρ_j > ρ_max' semantics, vectorised."""
    best_j = torch.argmax(sims_masked, dim=1).to(torch.int32)
    best = torch.gather(sims_masked, 1, best_j.long()[:, None])[:, 0]
    improve = best > rho_self
    return (torch.where(improve, best_j, prev_assign),
            torch.where(improve, best, rho_self))


def _nt_tail(docs: SparseDocs, t_th: int) -> torch.Tensor:
    """(B,) int32 — (ntH)_i: live tuples with term id >= t_th."""
    return ((docs.ids >= t_th) & docs.row_mask()).sum(dim=1,
                                                       dtype=torch.int32)


def _verify_mult(docs: SparseDocs, n_cand: torch.Tensor,
                 t_th: int) -> torch.Tensor:
    """Verification cost: |Z_i| exact Region-3 partials of (ntH)_i mults."""
    return (n_cand.long() * _nt_tail(docs, t_th)).sum()


def default_ub(rho_self: torch.Tensor, k: int) -> torch.Tensor:
    """(B, G) 'no bound known' upper bounds: +inf."""
    return torch.full((rho_self.shape[0], n_ub_groups(k)), torch.inf,
                      dtype=torch.float32, device=rho_self.device)


def _is_own(assign: torch.Tensor, k: int, k0: int = 0) -> torch.Tensor:
    """(B, K) bool — True at each object's assigned centroid, the columns
    being the global ids [k0, k0 + K)."""
    cols = torch.arange(k0, k0 + k, device=assign.device)
    return cols[None, :] == assign.long()[:, None]


def _second_best(sims: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """(B,) — max_{j != assign_i} sims[i, j]: the tight bound refresh."""
    return sims.masked_fill(_is_own(assign, sims.shape[1]),
                            -torch.inf).amax(dim=1)


def _group_bounds(b: torch.Tensor, assign: torch.Tensor, k: int,
                  k0: int = 0) -> torch.Tensor:
    """(B, G) per-bound-group max of the per-centroid bounds ``b``, each
    object's assigned centroid excluded.  ``b``'s columns are the global
    ids [k0, k0 + b.shape[1]) of K (all K by default; a mesh's centroid
    shard passes its slice, and its groups without a column of the slice
    stay -inf for the reduction over the shards).  The ragged final group
    pads with -inf; a group holding only the assigned centroid refreshes
    to -inf ('nothing to find here', which drift never loosens)."""
    k_loc = b.shape[1]
    masked = b.masked_fill(_is_own(assign, k_loc, k0), -torch.inf)
    gsz, g = ub_group_size(k), n_ub_groups(k)
    lo, hi = k0 // gsz, -(-(k0 + k_loc) // gsz)
    masked = torch.nn.functional.pad(
        masked, (k0 - lo * gsz, hi * gsz - k0 - k_loc), value=-torch.inf)
    local = masked.view(b.shape[0], hi - lo, gsz).amax(dim=2)
    if (lo, hi) == (0, g):
        return local
    out = torch.full((b.shape[0], g), -torch.inf, device=b.device)
    out[:, lo:hi] = local
    return out


def _group_active(ub: torch.Tensor, rho_self: torch.Tensor, k: int,
                  k0: int = 0, k_loc: int | None = None):
    """((B, G) active groups, (B, K_loc) their centroids, the global ids
    [k0, k0 + K_loc), all K by default): a group whose bound is <= ρ_self
    cannot hold a strict improver."""
    ga = ub > rho_self[:, None]
    cols = ub_group_of(k, ub.device)[k0:k0 + (k if k_loc is None else k_loc)]
    return ga, ga[:, cols]


def _binary(x: torch.Tensor) -> torch.Tensor:
    return (x > 0.0).to(torch.float32)


def _pair_counts(dsk: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """(B, K) float32 group pairs where both sketches are live: a product of
    0/1 sketches over at most 64 slots, exact in float32."""
    return ops.sketch_sim(_binary(dsk), _binary(msk))


def _sketch_pairs(docs: SparseDocs, index: MeanIndex,
                  dsk: torch.Tensor | None = None) -> torch.Tensor:
    """(B, K) sketch-product multiplications per (object, centroid): a
    sparse implementation of Σ_g ||x_g||·||c_g|| multiplies only groups
    where both sketches are nonzero."""
    if dsk is None:
        dsk = doc_sketch(docs.ids, docs.vals, index.dim)
    return _pair_counts(dsk, index.sketch_t)


# bounds-esicp refines the ES bound with the Region-3 sketch only where the
# crude bound sits within striking distance of the threshold:
# rho12 + BETA·y·v_th <= ρ_self (``repro``'s SKETCH_MARGIN_BETA).
SKETCH_MARGIN_BETA = 0.5


def _region3_bound(docs: SparseDocs, index: MeanIndex,
                   r3_sketch: torch.Tensor | None = None):
    """Sketch-refined Region-3 bound: ((B, K) bound, (B, K) check cost).

    Per-group L2 norms of the document tail (ids >= t_th) against the
    per-group norms of each centroid's Region-3 entries (``r3_sketch``,
    :func:`repro_torch.core.meanindex.region3_sketch`, computed here when
    not given); per-group Cauchy–Schwarz bounds the exact Region-3 partial.
    The cost counts group pairs where both sketches are live.
    """
    t_th = index.params.t_th
    if r3_sketch is None:
        r3_sketch = region3_sketch(index)
    tail = torch.where((docs.ids >= t_th) & docs.row_mask(), docs.vals, 0.0)
    dsk = doc_sketch(docs.ids, tail, index.dim)
    return ops.sketch_sim(dsk, r3_sketch), _pair_counts(dsk, r3_sketch)


# ---------------------------------------------------------------------------
# Algorithms.  Each takes the backend as its first argument.
# ---------------------------------------------------------------------------

def _mivi(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """Alg. 1 — exact scan of the mean-inverted index, no filters."""
    ub = default_ub(rho_self, index.k) if ub is None else ub
    out = bk.accumulate(docs, index, torch.zeros_like(xstate), mode="exact")
    assign, rho = _finalize(out["sims"], prev_assign, rho_self)
    n_cand = torch.full_like(assign, index.k)
    return AssignResult(assign, rho, n_cand, out["mult"],
                        assign != prev_assign, ub)


def _icp(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """Auxiliary filter only (Kaukoranta+): skip invariant centroids for
    'more similar' objects."""
    ub = default_ub(rho_self, index.k) if ub is None else ub
    out = bk.accumulate(docs, index, xstate, mode="exact")
    col_ok = col_ok_mask(index, xstate)
    sims = out["sims"].masked_fill_(~col_ok, -torch.inf)
    assign, rho = _finalize(sims, prev_assign, rho_self)
    n_cand = col_ok.sum(dim=1, dtype=torch.int32)
    return AssignResult(assign, rho, n_cand, out["mult"],
                        assign != prev_assign, ub)


def _es_core(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """ES upper bound + ICP: Algs. 2/3."""
    ub = default_ub(rho_self, index.k) if ub is None else ub
    out = bk.accumulate(docs, index, xstate, mode="esicp")
    col_ok = col_ok_mask(index, xstate)
    survivors, n_cand = bk.es_filter(out["rho12"], out["y"], rho_self,
                                     col_ok, index.params.v_th)
    sims = out["sims"].masked_fill_(~survivors, -torch.inf)
    assign, rho = _finalize(sims, prev_assign, rho_self)
    mult = out["mult"] + _verify_mult(docs, n_cand, index.params.t_th)
    return AssignResult(assign, rho, n_cand, mult, assign != prev_assign, ub)


def _esicp(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    return _es_core(bk, docs, index, prev_assign, rho_self, xstate, ub)


def _es(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """Ablation: ES main filter without ICP (App. D)."""
    return _es_core(bk, docs, index, prev_assign, rho_self,
                    torch.zeros_like(xstate), ub)


def _ta_icp(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """TA-ICP (App. F-A): per-object threshold v_ta = ρ_max / ||x||_1."""
    ub_in = default_ub(rho_self, index.k) if ub is None else ub
    # ||x||_1 summed in float64: the float32 result is then the same on
    # every device (the terms are float32, their float64 sum is exact in
    # practice).
    l1 = docs.vals.sum(dim=1, dtype=torch.float64).to(torch.float32)
    # ρ_max = -inf means 'no history' (iteration 1): clamped to 0, the
    # threshold is 0 (everything exact, nothing pruned).
    v_ta = torch.clamp(rho_self, min=0.0) / torch.clamp(l1, min=1e-12)
    out = bk.accumulate(docs, index, xstate, mode="ta", v_ta=v_ta)
    col_ok = col_ok_mask(index, xstate)
    ub_ta = out["rho12"] + out["y"] * v_ta[:, None]
    # Centroids with zero partial similarity are skipped: their bound
    # v_ta·y <= v_ta·||x||_1 = ρ_max can never strictly win.
    survivors = (out["rho12"] > 0.0) & (ub_ta > rho_self[:, None]) & col_ok
    sims = out["sims"].masked_fill_(~survivors, -torch.inf)
    assign, rho = _finalize(sims, prev_assign, rho_self)
    n_cand = survivors.sum(dim=1, dtype=torch.int32)
    mult = out["mult"] + _verify_mult(docs, n_cand, index.params.t_th)
    return AssignResult(assign, rho, n_cand, mult, assign != prev_assign,
                        ub_in)


def _cs_icp(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """CS-ICP (App. F-B): Cauchy–Schwarz bound on the tail subspace."""
    ub_in = default_ub(rho_self, index.k) if ub is None else ub
    t_th = index.params.t_th
    tail = torch.where((docs.ids >= t_th) & docs.row_mask(), docs.vals, 0.0)
    # Rounded float32 squares summed in float64, as in _ta_icp.
    x_tail_l2 = sqrt_rn((tail * tail).sum(dim=1, dtype=torch.float64)
                        .to(torch.float32))
    out = bk.accumulate(docs, index, xstate, mode="cs")
    col_ok = col_ok_mask(index, xstate)
    ub_cs = out["rho1"] + x_tail_l2[:, None] * sqrt_rn(out["sq"])
    survivors = (ub_cs > rho_self[:, None]) & col_ok
    sims = out["sims"].masked_fill_(~survivors, -torch.inf)
    assign, rho = _finalize(sims, prev_assign, rho_self)
    n_cand = survivors.sum(dim=1, dtype=torch.int32)
    mult = out["mult"] + _verify_mult(docs, n_cand, t_th)
    return AssignResult(assign, rho, n_cand, mult, assign != prev_assign,
                        ub_in)


# ---------------------------------------------------------------------------
# Bound-maintenance / sketch-gated modes (``repro``'s DESIGN.md §11).
#
# All three compute the FULL exact similarity matrix and finalize over it
# unmasked, so their assignments are MIVI's by construction.  The bounds
# and sketches drive only the Mult / |Z_i| accounting (what a CPU
# implementation exploiting the same pruning would pay) and the maintained
# ``ub`` state.
# ---------------------------------------------------------------------------

def _bounds(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """Cosine-adapted Elkan/Hamerly bounds per centroid group: a group whose
    drift-loosened bound is <= ρ_self is skipped (its centroids' posting
    entries cost nothing); active groups pay their gather and refresh to
    the exact per-group max non-assigned similarity."""
    k = index.k
    ub = default_ub(rho_self, k) if ub is None else ub
    out = bk.accumulate(docs, index, torch.zeros_like(xstate), mode="exact",
                        with_counts=True)
    assign, rho = _finalize(out["sims"], prev_assign, rho_self)
    ga, pa = _group_active(ub, rho_self, k)
    mult = torch.where(pa, out["counts"], 0).sum(dtype=torch.int64)
    n_cand = pa.sum(dim=1, dtype=torch.int32)
    ub_new = torch.where(ga, _group_bounds(out["sims"], assign, k), ub)
    return AssignResult(assign, rho, n_cand, mult, assign != prev_assign,
                        ub_new)


def _sketch(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """Block-vector sketch pre-filter (arxiv_2108.00895).

    The (B, S) × (S, K) sketch similarity, an upper bound on the exact
    cosine for non-negative data, gates the exact pass: only centroids
    whose sketch bound beats ρ_self are scanned.  The sketch check is
    charged sparsely (:func:`_sketch_pairs`).  Rows with ρ_self <= 0 cannot
    prune and pay the plain MIVI cost, so iteration-1 Mult is MIVI's.
    """
    k = index.k
    ub = default_ub(rho_self, k) if ub is None else ub
    out = bk.accumulate(docs, index, torch.zeros_like(xstate), mode="exact",
                        with_counts=True)
    dsk = doc_sketch(docs.ids, docs.vals, index.dim)
    sk_sims = bk.sketch_sim(docs, index, doc_sk=dsk)
    assign, rho = _finalize(out["sims"], prev_assign, rho_self)
    counts = out["counts"]
    rho_pos = rho_self > 0.0
    surv = sk_sims > rho_self[:, None]
    gathered = torch.where(surv, counts, 0).sum(dim=1, dtype=torch.int64)
    full = counts.sum(dim=1, dtype=torch.int64)
    sk_cost = _sketch_pairs(docs, index, dsk).sum(dim=1, dtype=torch.int64)
    mult = torch.where(rho_pos, sk_cost + gathered, full).sum()
    n_cand = torch.where(rho_pos, surv.sum(dim=1, dtype=torch.int32), k)
    return AssignResult(assign, rho, n_cand.to(torch.int32), mult,
                        assign != prev_assign, ub)


def _bounds_esicp(bk, docs, index, prev_assign, rho_self, xstate, ub=None,
                  r3_sketch=None):
    """Compounded pruning: bounds × index regions (ES + ICP) × sketch.

    Gates in the order a CPU implementation would run them: bounds (skip
    inactive groups), ICP, ES (Region-1/2 partial + Region-3 L1 bound),
    the margin-gated Region-3 sketch refinement for thin-margin ES
    survivors, and the exact Region-3 verification of the |Z_i| final
    survivors.  ``r3_sketch`` is the epoch's Region-3 mean sketch
    (computed here when not given).  The refreshed bound of each centroid
    comes from whichever gate pruned it, never from a similarity a pruned
    scan would not have computed.
    """
    k = index.k
    ub = default_ub(rho_self, k) if ub is None else ub
    out = bk.accumulate(docs, index, xstate, mode="esicp", with_counts=True)
    v_th = index.params.v_th
    rho12, y = out["rho12"], out["y"]
    rs = rho_self[:, None]
    col_ok = col_ok_mask(index, xstate)
    ga, pa = _group_active(ub, rho_self, k)
    gate = col_ok & pa
    crude, _ = bk.es_filter(rho12, y, rho_self, gate, v_th)
    r3_bound, r3_pairs = _region3_bound(docs, index, r3_sketch)
    es_ub = rho12 + y * v_th
    ref_ub = rho12 + torch.minimum(y * v_th, r3_bound)
    checked = crude & (rho12 + SKETCH_MARGIN_BETA * y * v_th <= rs)
    survivors = crude & (~checked | (ref_ub > rs))
    n_cand = survivors.sum(dim=1, dtype=torch.int32)
    assign, rho = _finalize(out["sims"], prev_assign, rho_self)
    mult = (torch.where(gate, out["counts"], 0).sum(dtype=torch.int64)
            + torch.where(checked, r3_pairs, 0.0).sum(dtype=torch.int64)
            + _verify_mult(docs, n_cand, index.params.t_th))
    # Centroids in inactive groups keep +inf here; their group's old bound
    # is kept by the torch.where(ga, ...) below, so the +inf never escapes.
    inf = torch.inf
    b = torch.where(survivors, out["sims"], inf)
    b = torch.minimum(b, torch.where(checked, ref_ub, inf))
    b = torch.minimum(b, torch.where(gate, es_ub, inf))
    b = torch.minimum(b, torch.where(pa & ~col_ok, rs, inf))
    ub_new = torch.where(ga, _group_bounds(b, assign, k), ub)
    return AssignResult(assign, rho, n_cand, mult, assign != prev_assign,
                        ub_new)


ALGORITHMS = {
    "mivi": _mivi,
    "icp": _icp,
    "es": _es,
    "esicp": _esicp,
    "ta-icp": _ta_icp,
    "cs-icp": _cs_icp,
    "bounds": _bounds,
    "sketch": _sketch,
    "bounds-esicp": _bounds_esicp,
}


def assign_batch(algo: str, backend, docs: SparseDocs, index: MeanIndex,
                 prev_assign: torch.Tensor, rho_self: torch.Tensor,
                 xstate: torch.Tensor, ub=None, *,
                 r3_sketch=None) -> AssignResult:
    """One assignment step over a batch of objects.

    ``ub`` is the maintained (B, G) per-group upper bound (bounds modes;
    None means +inf, which never prunes).  ``r3_sketch`` is the epoch's
    Region-3 mean sketch, for ``bounds-esicp`` only.
    """
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}; one of "
                         f"{sorted(ALGORITHMS)}")
    if r3_sketch is not None and algo != "bounds-esicp":
        raise ValueError("r3_sketch is an operand of 'bounds-esicp' only")
    extra = {} if r3_sketch is None else {"r3_sketch": r3_sketch}
    return ALGORITHMS[algo](backend, docs, index, prev_assign, rho_self,
                            xstate, ub, **extra)
