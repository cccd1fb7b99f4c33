"""Distributed spherical K-means on a process mesh (counterpart of
``repro.distributed.kmeans``).

Layout (``repro``'s, processes in place of devices; see
:mod:`repro_torch.launch.mesh`):
  objects   — split over the object axes ("pod", "data"): each rank owns a
              contiguous block of rows, the corpus padded to a multiple of
              |object| × ``obj_chunk`` rows as ``repro`` pads it;
  centroids — split over "model": each rank owns a contiguous (D, K/|model|)
              column block of ``means_t`` (its slice of the mean-inverted
              index);
  thresholds (t_th, v_th) — the same on every rank.

One step = assignment + update, on the rank's own rows and columns:
  1. per object chunk, the accumulators of the port's
     :class:`~repro_torch.core.backends.KernelBackend` on the rank's
     (D, K_loc) block with global ids from ``k0`` (``esicp_gather`` or
     ``sparse_sim``, ``esicp_filter``, ``sketch_sim`` and the Region-3
     bound for the bounded modes) and the local best;
  2. the (max, argmin-id) reduction over "model": ``all_reduce(MAX)`` of
     the local best, then ``all_reduce(MIN)`` of the local winner's global
     id where it reaches that max, else K — the lowest id wins, and a row
     moves only if the best strictly beats its ρ_self
     (``core/assignment.py:_finalize``); the bounds modes' per-group
     refresh reduces by MAX over "model" too;
  3. λ by ``segment_update`` on the rank's rows (assignments outside the
     block add nothing), span after span of ``LAMBDA_SPAN`` rows through
     its accumulating launch (``accumulate_means(init=)``), as ``repro``
     accumulates chunk after chunk; each span's term-major layout is built
     once a fit (spans of 32,768 rows, the streaming fit's chunks: the
     spans' layouts hold the rows' postings once, plus two per-term arrays
     a span; a layout the caller's corpus already holds is not reused);
     summed over the object group in ``lambda_dtype``, normalised in
     place;
  4. ρ_self by ``rho_gather`` where the centroid lives (0 elsewhere),
     summed over "model" (exactly one rank adds a nonzero);
  5. exact ICP flags from membership deltas (MAX over the object group),
     #changed, |Z| (exact int64) and the objective, and the per-group
     drift (MAX over "model") that loosens the bounds.

No collective runs over a group of one rank, so a world of one runs none,
and at (1, |model|) every sum is the one-device sum: the fit equals
:func:`repro_torch.core.lloyd.lloyd_fit` bit for bit (assignments, ρ_self,
means, #changed, |Z|, t_th).  Splitting the objects changes the order of
λ's and the objective's sums, as in ``repro``.  At most two (D, K_loc)
matrices live on a rank, the old means and λ/new means; the drift and the
bounds' group maxima are row-chunked and scattered, never a third.

EstParams runs only for ``algo == "esicp"``, as ``repro``'s ``mesh_fit``
does (the other modes keep t_th = 0; every mode is exact).  Its tables
need the global means: each rank sends its columns of one row block at a
time to its model group's first rank, which computes the one-device
tables on the same (rows, K) blocks, its rows' φ̃3, and (t_th, v_th), then
broadcasts them; φ̃3 is summed over the object group's first ranks in
rank order.

Not ported: ``PlanMeta`` and ``build_plan_operands`` (the port's kernels
plan per launch, as for ``kernels/plan.py``), the ``dist_fit`` deprecation
shim (the port has no old callers), and the scan variants of ``repro``'s
reference backend (``two_phase``, ``taat_unroll``, ``p_block``,
``p_tail``), which the port leaves out with that backend;
``two_phase=True`` raises as ``repro`` does for a non-reference backend.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.assignment import (SKETCH_MARGIN_BETA, _group_active,
                                         _group_bounds, _region3_bound)
from repro_torch.core.backends import KernelBackend, col_ok_mask
from repro_torch.core.estparams import (EstGrid, _est_minimize, _est_tables,
                                        _phi3, table_row_blocks)
from repro_torch.core.meanindex import (MeanIndex, StructuralParams,
                                        build_mean_index, normalized_means,
                                        region3_sketch, row_chunks)
from repro_torch.core.update import (draw_seed_rows, drift_loosen,
                                     group_drift, n_ub_groups,
                                     seed_centroids)
from repro_torch.sparse.matrix import SparseDocs
from repro_torch.sparse.store import DocStore

MESH_ALGOS = ("esicp", "mivi", "icp", "bounds", "sketch", "bounds-esicp")
# Rows a λ span: one segment_update launch each, onto the running λ.
LAMBDA_SPAN = 32_768
MESH_CKPT_FORMAT = "repro_torch.distributed/mesh-ckpt-v1"


def object_axes(mesh) -> tuple[str, ...]:
    """All mesh axes except 'model' split the objects."""
    return mesh.object_axes


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """Where a rank's rows lie: the corpus of ``n_docs`` rows padded to
    ``n_pad`` (a multiple of |object| × obj_chunk), ``n_loc`` rows a
    shard, this rank's from ``row0``, its first ``n_real`` backed by a
    document; its centroids are the global ids [k0, k0 + k_loc)."""

    n_docs: int
    n_pad: int
    n_loc: int
    row0: int
    n_real: int
    k: int
    k0: int
    k_loc: int

    @classmethod
    def of(cls, mesh, n_docs: int, k: int, obj_chunk: int) -> ShardGeometry:
        multiple = mesh.object_size * obj_chunk
        n_pad = n_docs + (-n_docs) % multiple
        n_loc = n_pad // mesh.object_size
        row0 = mesh.object_index * n_loc
        k_loc = k // mesh.model_size
        return cls(n_docs=n_docs, n_pad=n_pad, n_loc=n_loc, row0=row0,
                   n_real=max(0, min(n_loc, n_docs - row0)), k=k,
                   k0=mesh.model_index * k_loc, k_loc=k_loc)


@dataclasses.dataclass(frozen=True)
class DistKMeansState:
    """One rank's shards of the mesh state.

    index:    the rank's (D, K_loc) column block as a MeanIndex (means_t,
              moving flags, statistics; the thresholds are the global ones).
    assign, rho_self, rho_prev: (n_loc,) the rank's rows (global ids in
              ``assign``); rows past ``geo.n_real`` are padding: assign 0,
              ρ 0 and ub 0 at the start, as ``repro`` pads them.
    ub:       (n_loc, G) per-group bounds over the GLOBAL centroid groups.
    """

    index: MeanIndex
    assign: torch.Tensor
    rho_self: torch.Tensor
    rho_prev: torch.Tensor
    iteration: int
    ub: torch.Tensor
    geo: ShardGeometry

    @property
    def means_t(self) -> torch.Tensor:
        return self.index.means_t

    @property
    def moving(self) -> torch.Tensor:
        return self.index.moving


def _local_index(means_t: torch.Tensor, moving: torch.Tensor | None,
                 params: StructuralParams) -> MeanIndex:
    """The rank's (D, K_loc) column block as a MeanIndex: the view the
    kernel backend's accumulators take (the thresholds are the global
    ones, the same on every rank)."""
    return build_mean_index(means_t, params, moving=moving)


def _place_store_sharded(store: DocStore, geo: ShardGeometry,
                         dev: torch.device) -> SparseDocs:
    """The rank's real rows of a DocStore on ``dev``, read from the chunks
    that hold them (the host holds one chunk's slice at a time, and the
    rank only its rows)."""
    r0, r1 = geo.row0, geo.row0 + geo.n_real
    c, p = store.chunk_size, store.pad_width
    parts = [(np.zeros((0, p), np.int32), np.zeros((0, p), np.float32),
              np.zeros((0,), np.int32))]
    for ci in range(r0 // c, -(-r1 // c)):
        a, b = max(r0 - ci * c, 0), min(r1 - ci * c, c)
        parts.append(tuple(x[a:b] for x in store.host_chunk(ci)))
    cat = lambda j: torch.from_numpy(np.concatenate([q[j] for q in parts]))
    return SparseDocs(cat(0), cat(1), cat(2), store.dim).to(dev).validate()


def _local_docs(docs, geo: ShardGeometry, dev: torch.device) -> SparseDocs:
    """The rank's real rows on ``dev``: a view of resident documents (the
    documents themselves when the rank owns them all, so their term-major
    layout is kept), or a store's (:func:`_place_store_sharded`)."""
    if isinstance(docs, DocStore):
        return _place_store_sharded(docs, geo, dev)
    r0, r1 = geo.row0, geo.row0 + geo.n_real
    if (r0, r1) == (0, docs.n_docs):
        return docs.to(dev).validate()
    return docs.slice_rows(r0, r1 - r0).to(dev).validate()


def _seed_pick(n_docs: int, k: int, seed: int, seed_rows) -> torch.Tensor:
    if seed_rows is None:
        pick = draw_seed_rows(n_docs, k, seed=seed)
    elif torch.is_tensor(seed_rows):
        pick = seed_rows.cpu()
    else:
        pick = torch.tensor(np.array(seed_rows))
    pick = pick.long()
    if pick.shape != (k,) or torch.unique(pick).numel() != k:
        raise ValueError(f"seed_rows must hold {k} distinct row indices")
    return pick


def dist_init_state(docs, k: int, mesh, *, obj_chunk: int = 1024,
                    seed: int = 0, seed_rows=None) -> DistKMeansState:
    """The rank's shards of the initial state: its own seed columns only
    (the documents ``seed_rows``, else drawn from ``seed`` as
    :func:`repro_torch.core.update.init_state` draws them, of which it
    builds the columns [k0, k0 + K_loc)), its rows at ρ = -inf and
    ub = +inf, the padding rows at 0.  ``docs`` is resident SparseDocs or a
    DocStore (the rank reads only its seed rows from the chunks)."""
    if k % mesh.model_size:
        raise ValueError(f"K={k} must divide over the model axis "
                         f"({mesh.model_size})")
    dev = mesh.device
    geo = ShardGeometry.of(mesh, docs.n_docs, k, obj_chunk)
    pick = _seed_pick(docs.n_docs, k, seed, seed_rows)[
        geo.k0:geo.k0 + geo.k_loc]
    if isinstance(docs, DocStore):
        sel = docs.gather_rows(pick.numpy(), device=dev)
    else:
        p = pick.to(docs.device)
        sel = SparseDocs(docs.ids[p], docs.vals[p], docs.nnz[p],
                         docs.dim).to(dev)
    index = _local_index(seed_centroids(sel, geo.k_loc), None,
                         StructuralParams.trivial(docs.dim))
    real = torch.arange(geo.n_loc, device=dev) < geo.n_real
    rho0 = torch.where(real, -torch.inf, 0.0)
    return DistKMeansState(
        index=index,
        assign=torch.zeros((geo.n_loc,), dtype=torch.int32, device=dev),
        rho_self=rho0, rho_prev=rho0.clone(), iteration=0,
        ub=torch.where(real, torch.inf, 0.0)[:, None].expand(
            geo.n_loc, n_ub_groups(k)).contiguous(),
        geo=geo)


# ---------------------------------------------------------------------------
# The step.
# ---------------------------------------------------------------------------

def _assign_chunk(algo: str, bk, mesh, docs: SparseDocs, index: MeanIndex,
                  geo: ShardGeometry, cassign, crho, cxs, cub, r3_sketch):
    """One object chunk on the rank's columns -> (new assignment (C,),
    |Z| of its columns (int64), refreshed bounds (C, G))."""
    k, k0, k_loc = geo.k, geo.k0, geo.k_loc
    v_th = index.params.v_th
    es = algo in ("esicp", "bounds-esicp")
    out = bk.accumulate(docs, index, cxs, mode="esicp" if es else "exact",
                        diag=False)
    sims = out["sims"]
    col_ok = col_ok_mask(index, cxs)
    rs = crho[:, None]
    b = None
    if algo == "esicp":
        surv, n_cand = bk.es_filter(out["rho12"], out["y"], crho, col_ok,
                                    v_th)
        masked = sims.masked_fill_(~surv, -torch.inf)
    elif algo == "mivi":
        masked = sims
        n_cand = torch.full_like(crho, k_loc, dtype=torch.int32)
    elif algo == "icp":
        masked = sims.masked_fill_(~col_ok, -torch.inf)
        n_cand = col_ok.sum(dim=1, dtype=torch.int32)
    else:
        # The bounded modes are exact by construction: selection runs over
        # the full similarity rows; the gates drive |Z| and the bounds.
        masked = sims
        ga, pa = _group_active(cub, crho, k, k0, k_loc)
        if algo == "bounds":
            n_cand = pa.sum(dim=1, dtype=torch.int32)
            b = sims
        elif algo == "sketch":
            surv = torch.where((crho > 0.0)[:, None],
                               bk.sketch_sim(docs, index) > rs, True)
            n_cand = surv.sum(dim=1, dtype=torch.int32)
        else:                                       # bounds-esicp
            rho12, y = out["rho12"], out["y"]
            gate = col_ok & pa
            crude, _ = bk.es_filter(rho12, y, crho, gate, v_th)
            r3_bound, _ = _region3_bound(docs, index, r3_sketch)
            es_ub = rho12 + y * v_th
            ref_ub = rho12 + torch.minimum(y * v_th, r3_bound)
            checked = crude & (rho12 + SKETCH_MARGIN_BETA * y * v_th <= rs)
            surv = crude & (~checked | (ref_ub > rs))
            n_cand = surv.sum(dim=1, dtype=torch.int32)
            inf = torch.inf
            b = torch.where(surv, sims, inf)
            b = torch.minimum(b, torch.where(checked, ref_ub, inf))
            b = torch.minimum(b, torch.where(gate, es_ub, inf))
            b = torch.minimum(b, torch.where(pa & ~col_ok, rs, inf))

    lidx = torch.argmax(masked, dim=1)
    lbest = torch.gather(masked, 1, lidx[:, None])[:, 0]
    best = mesh.all_reduce(lbest.clone(), "max", over="model")
    cand = torch.where(lbest >= best, (lidx + k0).to(torch.int32), k)
    widx = mesh.all_reduce(cand.to(torch.int32), "min", over="model")
    na = torch.where(best > crho, widx, cassign)
    cub_new = cub
    if b is not None:
        gb = mesh.all_reduce(_group_bounds(b, na, k, k0), "max",
                             over="model")
        cub_new = torch.where(ga, gb, cub)
    return na, n_cand.sum(dtype=torch.int64), cub_new


def _local_ids(assign: torch.Tensor, geo: ShardGeometry) -> torch.Tensor:
    """Global ids -> the rank's column ids, -1 outside its block."""
    a = assign - geo.k0
    return torch.where((a >= 0) & (a < geo.k_loc), a, -1).to(torch.int32)


def _step(state: DistKMeansState, docs: SparseDocs, spans: list,
          params: StructuralParams, *, mesh, algo: str, obj_chunk: int, bk,
          lambda_dtype):
    geo = state.geo
    n = geo.n_real
    dev = state.assign.device
    index = state.index if state.index.params == params else \
        state.index.with_params(params)
    xstate = ((state.rho_self >= state.rho_prev) if state.iteration >= 2
              else torch.zeros_like(state.rho_self, dtype=torch.bool))
    r3 = region3_sketch(index) if algo == "bounds-esicp" else None
    assign = state.assign.clone()
    ub = state.ub.clone()
    cand = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, n, obj_chunk):
        c = docs.slice_rows(s, obj_chunk)
        e = s + c.n_docs
        assign[s:e], nc, ub[s:e] = _assign_chunk(
            algo, bk, mesh, c, index, geo, state.assign[s:e],
            state.rho_self[s:e], xstate[s:e], state.ub[s:e], r3)
        cand += nc

    # ---- update: λ of the rank's rows and columns, summed over objects
    new_loc, old_loc = _local_ids(assign[:n], geo), _local_ids(
        state.assign[:n], geo)
    lam = None
    for i, span in enumerate(spans):
        s = i * LAMBDA_SPAN
        lam = bk.accumulate_means(span, new_loc[s:s + span.n_docs],
                                  k=geo.k_loc, init=lam)
    if lam is None:
        lam = torch.zeros((index.dim, geo.k_loc), dtype=torch.float32,
                          device=dev)
    if lambda_dtype != torch.float32:
        # A compressed reduction (the k-means analogue of gradient
        # compression): not bit-exact against one device.
        lam.copy_(mesh.all_reduce(lam.to(lambda_dtype), over="object"))
    else:
        mesh.all_reduce(lam, over="object")
    means_t = normalized_means(lam, index.means_t)

    changed = (assign[:n] != state.assign[:n]).to(torch.int32)
    mv = torch.zeros((geo.k_loc + 1,), dtype=torch.int32, device=dev)
    for ids in (new_loc, old_loc):
        mv.scatter_reduce_(0, torch.where(ids >= 0, ids, geo.k_loc).long(),
                           changed, "amax")
    moving = mesh.all_reduce(mv[:geo.k_loc].contiguous(), "max",
                             over="object") > 0
    new_index = _local_index(means_t, moving, params)

    rho = torch.zeros((geo.n_loc,), dtype=torch.float32, device=dev)
    if n:
        rho[:n] = bk.self_sims(docs, new_loc, means_t)
    mesh.all_reduce(rho, over="model")
    delta = mesh.all_reduce(group_drift(means_t, index.means_t, k=geo.k,
                                        k0=geo.k0), "max", over="model")
    del index
    new = DistKMeansState(index=new_index, assign=assign, rho_self=rho,
                          rho_prev=state.rho_self,
                          iteration=state.iteration + 1,
                          ub=drift_loosen(ub, delta), geo=geo)

    cand = mesh.all_reduce(cand, over="model")
    counts = mesh.all_reduce(torch.stack([changed.sum(dtype=torch.int64),
                                          cand]), over="object")
    objective = mesh.all_reduce(rho[:n].double().sum(), over="object")
    n_changed, n_cand = counts.tolist()
    return new, {"n_changed": n_changed, "n_candidates": n_cand,
                 "objective": float(objective)}


def make_step_fn(mesh, *, algo: str = "esicp", k: int,
                 obj_chunk: int = 2048, lambda_dtype=torch.float32,
                 two_phase: bool = False,
                 backend: KernelBackend | None = None):
    """The fused assignment + update step of this rank:
    ``step(state, docs, params) -> (new_state, diag)``, ``docs`` the
    rank's real rows.  ``backend`` carries the gathers' tuned tiles
    (default: a plain :class:`KernelBackend`)."""
    if two_phase:
        raise ValueError("two_phase is a reference-backend scan variant; "
                         "the port runs its kernels, which have none")
    if algo not in MESH_ALGOS:
        raise ValueError(f"algo {algo!r} is not available on the mesh "
                         f"strategy; one of {MESH_ALGOS}")
    if k % mesh.model_size:
        raise ValueError(f"K={k} must divide over the model axis "
                         f"({mesh.model_size})")
    bk = backend or KernelBackend()
    spans = {}                   # the λ spans of the rows last stepped

    def step(state, docs, params):
        if spans.get("docs") is not docs:
            spans["docs"] = docs
            spans["list"] = [docs.slice_rows(s, LAMBDA_SPAN)
                             for s in range(0, docs.n_docs, LAMBDA_SPAN)]
        return _step(state, docs, spans["list"], params, mesh=mesh,
                     algo=algo, obj_chunk=obj_chunk, bk=bk,
                     lambda_dtype=lambda_dtype)

    return step


def dist_assignment_update(step_fn, state: DistKMeansState, docs, t_th,
                           v_th):
    """One fused step; returns (new_state, diag dict)."""
    return step_fn(state, docs, StructuralParams(t_th, v_th))


# ---------------------------------------------------------------------------
# The global means, a row block at a time.
# ---------------------------------------------------------------------------

def _block_parts(mesh, blk: torch.Tensor, *, every: bool = False):
    """Every model-group member's (rows, K_loc) block ``blk`` (one shape
    on all), in group order, on the group's first rank (on every member
    with ``every``); None on the others.  A block crosses as the flat
    index and bit pattern of its entries whose bits are not all 0: most
    entries of the means are 0 (a mean sums its documents' few hundred
    terms of a vocabulary of 10^5–10^6), so a block moves a small part of
    its bytes, and the block rebuilt is the sent one bit for bit."""
    if mesh.model_size == 1:
        return [blk]
    bits = blk.reshape(-1).view(torch.int32)
    idx = torch.nonzero(bits).flatten()
    n = torch.tensor([idx.numel()], dtype=torch.int64, device=blk.device)
    counts = torch.cat(mesh.all_gather(n, over="model")).tolist()
    payload = torch.zeros((2, max(max(counts), 1)), dtype=torch.int32,
                          device=blk.device)
    payload[0, :len(idx)] = idx.to(torch.int32)
    payload[1, :len(idx)] = bits[idx]
    parts = (mesh.all_gather(payload, over="model") if every
             else mesh.gather(payload, over="model"))
    if parts is None:
        return None
    out = []
    for part, c in zip(parts, counts):
        b = torch.zeros((blk.numel(),), dtype=torch.int32, device=blk.device)
        b[part[0, :c].long()] = part[1, :c]
        out.append(b.view(torch.float32).view(blk.shape))
    return out


def _gathered_rows(mesh, means_t: torch.Tensor):
    """``block(s, e)``: rows [s, e) of the global (D, K) means on the
    model group's first rank (None on the others, which still send their
    columns).  One (rows, K) block at a time, never a (D, K) matrix."""
    if mesh.model_size == 1:
        return lambda s, e: means_t[s:e]

    def block(s, e):
        parts = _block_parts(mesh, means_t[s:e])
        return None if parts is None else torch.cat(parts, dim=1)

    return block


def _mesh_estimate(mesh, docs, df, state: DistKMeansState, *,
                   grid: EstGrid) -> StructuralParams:
    """EstParams over the global means and every rank's rows; the same
    (t_th, v_th) on every rank (see the module note)."""
    geo = state.geo
    d, k = state.index.dim, geo.k
    block = _gathered_rows(mesh, state.index.means_t)
    dev = mesh.device
    out = torch.zeros((2,), dtype=torch.float64, device=dev)
    if mesh.is_leader("model"):
        tables = _est_tables(df.to(dev), d, k, block, grid)
        phi3 = _phi3(docs, state.rho_self[:geo.n_real], tables, k=k,
                     grid=grid)
        if mesh.object_size > 1:
            parts = mesh.all_gather(phi3, over="object")
            phi3 = torch.zeros_like(phi3)
            for p in parts:
                phi3 += p
        params, _ = _est_minimize(*tables[:4], phi3)
        out[0], out[1] = params.t_th, params.v_th
    else:
        for s, e in table_row_blocks(d, k, grid):
            block(s, e)
    t_th, v_th = mesh.broadcast(out, over="model").tolist()
    return StructuralParams(int(t_th), v_th)


# ---------------------------------------------------------------------------
# Checkpoints in repro's format.
# ---------------------------------------------------------------------------

def _ckpt_save(directory: str, mesh, state: DistKMeansState,
               params: StructuralParams, *, step: int, history: list):
    """``repro``'s mesh checkpoint (global arrays, padded rows) written by
    rank 0: the rows gathered over the object group, ``means_t`` column
    block by column block into host memory (one (rows, K) block on the
    card at a time)."""
    from repro_torch.checkpoint.store import save_checkpoint

    geo = state.geo
    rows = {}
    if mesh.model_index == 0:
        for name in ("assign", "rho_self", "rho_prev", "ub"):
            got = mesh.gather(getattr(state, name), over="object")
            if got is not None:
                rows[name] = torch.cat(got).cpu().numpy()
    means = moving = None
    if mesh.object_index == 0:
        block = _gathered_rows(mesh, state.index.means_t)
        if mesh.rank == 0:
            means = np.empty((state.index.dim, geo.k), np.float32)
        for s, e in row_chunks(state.index.dim, geo.k):
            blk = block(s, e)
            if means is not None:
                means[s:e] = blk.cpu().numpy()
        got = mesh.gather(state.index.moving.to(torch.uint8), over="model")
        if got is not None:
            moving = torch.cat(got).bool().cpu().numpy()
    if mesh.rank != 0:
        return
    tree = {**rows, "means_t": means, "moving": moving,
            "iteration": np.asarray(state.iteration, np.int32),
            "t_th": np.asarray(params.t_th, np.int32),
            "v_th": np.asarray(params.v_th, np.float32)}
    save_checkpoint(directory, tree, step=step,
                    extra={"format": MESH_CKPT_FORMAT, "history": history,
                           "n_docs": geo.n_docs})


# ---------------------------------------------------------------------------
# Drivers.
# ---------------------------------------------------------------------------

def _tuned_backend(docs, local: SparseDocs, k: int, tune: str):
    """The kernel backend with the tuner's cached winner (cache-only: the
    mesh never runs a search; 'search' reads the cache as 'cached' does),
    keyed on the whole corpus where this rank holds it, else on its rows
    (a store's first chunk, as ``repro`` probes it)."""
    if tune == "off":
        return KernelBackend()
    from repro_torch.tune.search import ensure_tuned

    if isinstance(docs, DocStore):
        probe = docs.chunk(0, device=local.device)
    else:
        probe = docs if docs.device == local.device else local
    return KernelBackend(ensure_tuned(probe, k=k, mode="cached"))


def mesh_fit(docs, k: int, mesh, *, algo: str = "esicp", max_iter: int = 40,
             obj_chunk: int = 1024, seed: int = 0, seed_rows=None,
             est_iters=(1, 2), est_grid: EstGrid | None = None, df=None,
             checkpoint_dir: str | None = None, checkpoint_every: int = 5,
             resume: bool = False, tune: str = "off",
             lambda_dtype=torch.float32, two_phase: bool = False,
             trajectory: list | None = None):
    """The distributed Lloyd loop with EstParams and checkpoints, run by
    every rank of ``mesh`` with the same arguments.

    ``docs`` is the whole corpus: resident SparseDocs (each rank takes a
    view of its rows and moves them to its device) or a DocStore (each
    rank reads its rows from the chunks).  ``seed_rows`` names the K seed
    documents (else drawn from ``seed``).  ``tune`` reads the tuner's
    cache only.  ``checkpoint_dir``: rank 0 writes ``repro``'s mesh
    checkpoint every ``checkpoint_every`` iterations; ``resume=True``
    continues from its latest one, the port's or ``repro``'s, on this mesh
    (:func:`repro_torch.distributed.elastic.reshard_state`).
    ``trajectory``, a list, receives this rank's real rows' assignment
    (on the host) after every iteration.

    Returns ``(state, history, converged, params)``: this rank's
    :class:`DistKMeansState`, the history (``iteration``, ``n_changed``,
    ``n_candidates``, ``cpr``, ``objective``, ``t_th``, ``v_th``,
    ``elapsed_s``; the same on every rank), the convergence flag and the
    final thresholds.  The ``mesh`` strategy of ``SphericalKMeans`` gathers
    the shards into an ordinary fitted model.
    """
    from repro_torch.cluster.config import ClusterConfig

    ClusterConfig(k=k, algo=algo, max_iter=max_iter, chunk_size=obj_chunk,
                  mesh=mesh, est_iters=est_iters,
                  checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every, tune=tune,
                  device=mesh.device.type).validate()
    if two_phase:
        raise ValueError("two_phase is a reference-backend scan variant; "
                         "the port runs its kernels, which have none")
    if resume and not checkpoint_dir:
        raise ValueError("resume=True needs checkpoint_dir")
    est_grid = est_grid or EstGrid()
    est_iters = tuple(est_iters)
    dev = mesh.device
    n = docs.n_docs
    geo = ShardGeometry.of(mesh, n, k, obj_chunk)
    local = _local_docs(docs, geo, dev)
    if df is None:
        df = docs.df
    df = torch.as_tensor(np.asarray(df.cpu() if torch.is_tensor(df)
                                    else df)).to(dev, torch.int32)
    bk = _tuned_backend(docs, local, k, tune)
    step_fn = make_step_fn(mesh, algo=algo, k=k, obj_chunk=obj_chunk,
                           lambda_dtype=lambda_dtype, backend=bk)
    if resume:
        from repro_torch.distributed.elastic import reshard_state

        state, params, history = reshard_state(checkpoint_dir, mesh,
                                               n_docs=n, k=k,
                                               obj_chunk=obj_chunk)
    else:
        state = dist_init_state(docs, k, mesh, obj_chunk=obj_chunk,
                                seed=seed, seed_rows=seed_rows)
        params, history = StructuralParams.trivial(docs.dim), []

    converged = False
    for r in range(state.iteration + 1, max_iter + 1):
        t0 = time.perf_counter()
        state, diag = step_fn(state, local, params)
        if algo == "esicp" and r in est_iters:
            params = _mesh_estimate(mesh, local, df, state, grid=est_grid)
            state = dataclasses.replace(
                state, index=state.index.with_params(params))
        history.append({"iteration": r, "n_changed": diag["n_changed"],
                        "n_candidates": diag["n_candidates"],
                        "cpr": diag["n_candidates"] / (n * k),
                        "objective": diag["objective"],
                        "t_th": params.t_th, "v_th": params.v_th,
                        "elapsed_s": time.perf_counter() - t0})
        if trajectory is not None:
            trajectory.append(state.assign[:geo.n_real].cpu())
        if checkpoint_dir and r % checkpoint_every == 0:
            _ckpt_save(checkpoint_dir, mesh, state, params, step=r,
                       history=history)
        if diag["n_changed"] == 0:
            converged = True
            break
    return state, history, converged, params


def make_assign_fn(mesh, *, k: int, obj_chunk: int = 2048):
    """Serving mode, the mesh classify: ``fn(docs, means_t) -> (assign
    (B,) int32 global ids, sims (B,) float32)`` for ``docs``' rows against
    a frozen index whose (D, K_loc) column block on this rank is
    ``means_t``.  The ranks of one model group pass the same rows.  Exact
    ``sparse_sim`` scores and the (max, argmin-id) reduction over
    "model": ``classify_docs``' answer bit for bit."""
    from repro_torch.kernels import ops

    if k % mesh.model_size:
        raise ValueError(f"K={k} must divide over the model axis "
                         f"({mesh.model_size})")
    k0 = mesh.model_index * (k // mesh.model_size)

    def fn(docs: SparseDocs, means_t: torch.Tensor):
        dev = means_t.device
        docs = docs.to(dev)
        n = docs.n_docs
        assign = torch.empty((n,), dtype=torch.int32, device=dev)
        sims = torch.empty((n,), dtype=torch.float32, device=dev)
        for s in range(0, n, obj_chunk):
            c = docs.slice_rows(s, obj_chunk)
            scores = ops.sparse_sim(c.ids, c.vals, means_t)[0]
            lidx = torch.argmax(scores, dim=1)
            lbest = torch.gather(scores, 1, lidx[:, None])[:, 0]
            best = mesh.all_reduce(lbest.clone(), "max", over="model")
            cand = torch.where(lbest >= best, (lidx + k0).to(torch.int32), k)
            e = s + c.n_docs
            assign[s:e] = mesh.all_reduce(cand.to(torch.int32), "min",
                                          over="model")
            sims[s:e] = best
        return assign, sims

    return fn


def gather_state(mesh, state: DistKMeansState):
    """The whole state on every rank -> (means_t (D, K), moving (K,),
    assign, rho_self, rho_prev (N,), ub (N, G)), padding trimmed.  Costs
    one (D, K) matrix on every rank (gathered a row block at a time beside
    the rank's own block, which the caller then drops)."""
    geo = state.geo
    means_t = state.index.means_t
    moving = state.index.moving
    if mesh.model_size > 1:
        full = torch.empty((means_t.shape[0], geo.k), dtype=torch.float32,
                           device=means_t.device)
        for s, e in row_chunks(means_t.shape[0], geo.k):
            full[s:e] = torch.cat(_block_parts(mesh, means_t[s:e],
                                               every=True), dim=1)
        means_t = full
        moving = torch.cat(mesh.all_gather(moving.to(torch.uint8),
                                           over="model")).bool()
    rows = [torch.cat(mesh.all_gather(t, over="object"))[:geo.n_docs]
            for t in (state.assign, state.rho_self, state.rho_prev,
                      state.ub)]
    return (means_t, moving, *rows)
