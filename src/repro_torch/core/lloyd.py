"""Lloyd-iteration drivers (counterpart of ``repro.core.lloyd``):
``lloyd_fit`` over resident documents and ``streaming_fit`` over a
:class:`repro_torch.sparse.store.DocStore`.

Each iteration: an assignment epoch over row batches (``assign_batch``),
the update step, and — at the EstParams iterations (1–2 by default) — a
new (t_th, v_th).  It stops when no assignment changed or at ``max_iter``,
the stop rule of ``repro``'s prologue + ``lax.while_loop``, and records
the same history rows.

The loops are plain Python; their one host read per iteration brings the
diagnostics (Mult, |Z| sum, #changed, objective, n_moving) across together,
and that read also ends the iteration's device work, so ``elapsed_s`` is
the iteration's wall time.  ``repro`` pads N to a batch multiple with dead
rows; here the last batch is simply shorter, which changes nothing (dead
rows contribute nothing to any diagnostic).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.assignment import ALGORITHMS, assign_batch
from repro_torch.core.backends import KernelBackend
from repro_torch.core.estparams import (EstGrid, estimate_params,
                                        estimate_params_store)
from repro_torch.core.meanindex import (StructuralParams, build_mean_index,
                                        column_dots, normalized_means,
                                        region3_sketch, row_chunks)
from repro_torch.core.update import (KMeansState, drift_loosen, group_drift,
                                     init_state, init_state_from_store,
                                     moving_flags, n_ub_groups, update_step)
from repro_torch.kernels.ref import sqrt_rn
from repro_torch.sparse.matrix import SparseDocs


@dataclasses.dataclass
class LloydResult:
    state: KMeansState
    assign: torch.Tensor
    history: list
    params: StructuralParams
    converged: bool
    n_iter: int
    # (N,) int32 assignment after each iteration, when the fit was asked to
    # keep them (trajectory tests); else None.
    trajectory: list | None = None
    # Streaming fits only: (next_epoch, next_chunk) where a resumed fit
    # would continue — None for converged and resident fits.
    cursor: tuple | None = None
    # Streaming fits only: per iteration, the host seconds the fit waited
    # on the chunk prefetcher ("wait_s") and the chunks whose copy had not
    # completed when taken ("late").
    prefetch: dict | None = None
    # Streaming fits only: per iteration, {pass: seconds} between the
    # fit's marks (:class:`_PassClock`).
    passes: list | None = None
    # The gathers' tuned config the fit ran with (repro_torch.tune.
    # TunedConfig), or None when tuning was off, missed or on the CPU; a
    # streaming fit's is its first chunk's.
    tuned: object | None = None

    @property
    def objective(self) -> float:
        """J = Σ_i x_i·μ_{a(i)} (Eq. 47) at the final state."""
        return float(self.state.rho_self.double().sum())


def initial_params(spec, dim: int) -> StructuralParams:
    """'auto' / None / StructuralParams -> the fit's starting thresholds
    ('auto' and None start trivial: iteration 1 is the unfiltered scan)."""
    if isinstance(spec, StructuralParams):
        return spec
    return StructuralParams.trivial(dim)


def _counters(dev) -> list:
    """[Mult, |Z| sum, #changed] as int64 device scalars."""
    return [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3)]


def _epoch_extra(algo: str, index) -> dict:
    # bounds-esicp's Region-3 mean sketch depends on the index alone: one
    # per epoch, not one per batch.
    return ({"r3_sketch": region3_sketch(index)}
            if algo == "bounds-esicp" else {})


def _assign_rows(algo, bk, docs: SparseDocs, index, prev_assign, rho_self,
                 xstate, ub, bs: int, extra: dict, assign_out, ub_out,
                 acc: list) -> None:
    """Assignment over ``docs``' rows in batches of ``bs``: writes the
    per-row results into ``assign_out``/``ub_out`` (row-aligned with
    ``docs``) and adds the diagnostics into ``acc``."""
    n = docs.n_docs
    for s in range(0, n, bs):
        e = min(s + bs, n)
        res = assign_batch(algo, bk, docs.slice_rows(s, bs), index,
                           prev_assign[s:e], rho_self[s:e], xstate[s:e],
                           ub[s:e], **extra)
        assign_out[s:e] = res.assign
        ub_out[s:e] = res.ub
        acc[0] += res.mult
        acc[1] += res.n_candidates.sum(dtype=torch.int64)
        acc[2] += res.changed.sum(dtype=torch.int64)


def _epoch(algo: str, bk, docs: SparseDocs, state: KMeansState, bs: int):
    """One assignment epoch over row batches -> (assign, ub, mult, cand,
    changed), the last three as device scalars."""
    assign = torch.empty_like(state.assign)
    ub = torch.empty_like(state.ub)
    acc = _counters(docs.device)
    _assign_rows(algo, bk, docs, state.index, state.assign, state.rho_self,
                 state.xstate, state.ub, bs, _epoch_extra(algo, state.index),
                 assign, ub, acc)
    return assign, ub, *acc


def _history_row(r: int, n: int, k: int, mult, cand, changed, state,
                 rho_real: torch.Tensor, elapsed_from: float) -> dict:
    """The iteration's one host read: every diagnostic crosses together
    (float64 holds these counts exactly below 2^53)."""
    mult_h, cand_h, changed_h, n_moving, objective = torch.stack([
        mult.double(), cand.double(), changed.double(),
        state.index.n_moving.double(), rho_real.double().sum(),
    ]).tolist()
    p = state.index.params
    return {
        "iteration": r,
        "mult": int(mult_h),
        "n_candidates": int(cand_h),
        "cpr": cand_h / (n * k),
        "n_changed": int(changed_h),
        "objective": objective,
        "n_moving": int(n_moving),
        "elapsed_s": time.perf_counter() - elapsed_from,
        "t_th": p.t_th,
        "v_th": p.v_th,
    }


def lloyd_fit(docs: SparseDocs, *, k: int, algo: str = "esicp",
              params="auto", batch_size: int = 4096, max_iter: int = 60,
              est_grid: EstGrid | None = None, est_iters=(1, 2),
              seed: int = 0, seed_rows=None, df: torch.Tensor | None = None,
              device="cuda", keep_trajectory: bool = False,
              tune: str = "off", tune_budget=None) -> LloydResult:
    """Single-host Lloyd fit on ``device`` (docs are moved there).

    algo:      one of ``repro_torch.core.assignment.ALGORITHMS``: 'mivi',
               'icp', 'es', 'esicp', 'ta-icp', 'cs-icp', 'bounds', 'sketch',
               'bounds-esicp'.  Every mode gives MIVI's assignments; they
               differ in Mult, |Z| and the maintained bounds.
    params:    'auto' (EstParams at ``est_iters``), a StructuralParams for
               fixed thresholds, or None (trivial).
    seed_rows: optional (K,) document indices for the initial centroids
               (else drawn from ``seed`` with a torch.Generator).
    tune:      'off' | 'cached' | 'search': the gathers' tile settings
               from the autotuner (``KernelBackend.prepare``, before the
               fit allocates its means); ``tune_budget`` a
               :class:`repro_torch.tune.SearchBudget` (or int max timed)
               for 'search'.  The settings change the launches, never the
               sums: the fit is the untuned one bit for bit.
    """
    dev = resolve_device(device)
    docs = docs.to(dev).validate()
    est_grid = est_grid or EstGrid()
    est_iters = tuple(est_iters)
    n = docs.n_docs
    if df is None:
        df = docs.df
    bk = KernelBackend().prepare(docs, k=k, tune=tune,
                                 tune_budget=tune_budget)
    state = init_state(docs, k, initial_params(params, docs.dim), seed=seed,
                       seed_rows=seed_rows)
    bs = max(1, min(batch_size, n))

    history, trajectory = [], [] if keep_trajectory else None
    converged = False
    for r in range(1, max_iter + 1):
        t0 = time.perf_counter()
        prev_assign = state.assign
        assign, ub, mult, cand, changed = _epoch(algo, bk, docs, state, bs)
        state = update_step(docs, assign, prev_assign, state,
                            state.index.params, k=k, backend=bk, ub=ub)
        if params == "auto" and r in est_iters:
            new_params, _ = estimate_params(docs, df, state.index.means_t,
                                            state.rho_self, k=k,
                                            grid=est_grid)
            state = dataclasses.replace(
                state, index=state.index.with_params(new_params))
        history.append(_history_row(r, n, k, mult, cand, changed, state,
                                    state.rho_self, t0))
        if keep_trajectory:
            trajectory.append(state.assign.cpu())
        if history[-1]["n_changed"] == 0:
            converged = True
            break

    return LloydResult(state=state, assign=state.assign, history=history,
                       params=state.index.params, converged=converged,
                       n_iter=len(history), trajectory=trajectory,
                       tuned=bk.tuned)


# ---------------------------------------------------------------------------
# The streaming fit over a DocStore.
# ---------------------------------------------------------------------------

STREAM_CKPT_FORMAT = "repro.cluster/stream-ckpt-v2"


@dataclasses.dataclass
class _EpochWork:
    """What an epoch builds chunk by chunk (and a mid-epoch checkpoint
    saves): the new assignment and bounds of every store row, the
    diagnostics so far, and — full mode — λ_t of the chunks so far."""

    assign: torch.Tensor        # (n_rows,) int32
    ub: torch.Tensor            # (n_rows, G) float32
    acc: list                   # [Mult, |Z| sum, #changed] int64 scalars
    lam: torch.Tensor | None = None   # (D, K) float32

    @classmethod
    def start(cls, state: KMeansState) -> _EpochWork:
        return cls(assign=state.assign.clone(), ub=state.ub.clone(),
                   acc=_counters(state.assign.device))


class _PassClock:
    """Seconds between marks in an epoch: on the card between CUDA events
    on the current stream (the device's timeline, read once the
    iteration's host read has ended its work), on the CPU the host clock
    (there every operation has ended when it returns)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def seconds(self) -> dict:
        """{name of the mark that ends a span: its seconds}."""
        return {name: (a.elapsed_time(b) / 1e3 if self.cuda else b - a)
                for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


def _minibatch_chunk(bk, docs: SparseDocs, index, prev_assign, m_mean,
                     counts, *, k: int, bs: int):
    """Sculley-style mini-batch step on one chunk's real rows.

    Exact nearest-centroid assignment (``sparse_sim``, first maximum on
    ties), then per-centre running means with per-centre counts:
    M_j <- (N_j·M_j + Σ_{a(x)=j} x) / (N_j + n_j) for the centres the chunk
    touched.  ``m_mean`` (D, K) and ``counts`` (K,) float32 are updated in
    place; the chunk's sums λ_t are the one new (D, K) matrix and receive
    the new index's means, M's columns over their norms.
    -> (assign (m,), #changed, new MeanIndex).
    """
    m = docs.n_docs
    assign = torch.empty((m,), dtype=torch.int32, device=docs.device)
    for s in range(0, m, bs):
        b = docs.slice_rows(s, bs)
        sims = bk.accumulate(b, index, None, mode="exact", diag=False)["sims"]
        assign[s:s + b.n_docs] = torch.argmax(sims, dim=1).to(torch.int32)
    changed = (assign != prev_assign).sum(dtype=torch.int64)
    sums = bk.accumulate_means(docs, assign, k=k)
    n_j = torch.bincount(assign.long(), minlength=k).to(torch.float32)
    new_counts = counts + n_j
    touched = n_j > 0
    denom = torch.clamp(new_counts, min=1.0)
    d = m_mean.shape[0]
    for s, e in row_chunks(d, k):
        blk = m_mean[s:e]
        blk.copy_(torch.where(touched, (counts * blk + sums[s:e]) / denom,
                              blk))
    counts.copy_(new_counts)
    norms = torch.clamp(sqrt_rn(column_dots(m_mean, m_mean)), min=1e-12)
    for s, e in row_chunks(d, k):
        torch.div(m_mean[s:e], norms, out=sums[s:e])
    return assign, changed, build_mean_index(sums, index.params)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _stream_ckpt_save(directory, *, step, state, work, m_mean, counts,
                      cursor, history, algo_mode, k, dim):
    """``repro``'s 17 leaves with ``repro``'s shapes: λ and the running
    means (K, D), transposed on the host (zeros where the mode keeps
    none).  Mult, |Z| and #changed are written int64 (exact)."""
    from repro_torch.checkpoint.store import save_checkpoint

    kd = lambda t: (np.zeros((k, dim), np.float32) if t is None
                    else np.ascontiguousarray(_host(t).T))
    i64 = lambda t: np.asarray(int(t), np.int64)
    tree = {
        "assign": state.assign, "rho_self": state.rho_self,
        "rho_prev": state.rho_self_prev,
        "iteration": np.asarray(state.iteration, np.int32),
        "ub": state.ub, "means_t": state.index.means_t,
        "moving": state.index.moving,
        "t_th": np.asarray(state.index.params.t_th, np.int32),
        "v_th": np.asarray(state.index.params.v_th, np.float32),
        "lam": kd(work.lam), "mult": i64(work.acc[0]),
        "cand": i64(work.acc[1]), "changed": i64(work.acc[2]),
        "assign_work": work.assign, "ub_work": work.ub,
        "m_mean": kd(m_mean),
        "counts": (np.zeros((k,), np.float32) if counts is None
                   else counts),
    }
    save_checkpoint(directory, tree, step=step,
                    extra={"format": STREAM_CKPT_FORMAT,
                           "cursor": list(cursor), "history": history,
                           "algo_mode": algo_mode})


def _stream_ckpt_restore(directory, *, n_rows, k, dim, dev):
    """A streaming checkpoint (the port's or ``repro``'s) on ``dev`` ->
    (state, work, m_mean, counts, cursor, history, algo_mode)."""
    from repro_torch.checkpoint.store import load_extra, restore_checkpoint

    extra = load_extra(directory)
    if not extra or extra.get("format") != STREAM_CKPT_FORMAT:
        raise ValueError(f"{directory} holds no {STREAM_CKPT_FORMAT} "
                         f"checkpoint (found "
                         f"{extra.get('format') if extra else None!r})")
    g = n_ub_groups(k)
    shapes = {"assign": (n_rows,), "rho_self": (n_rows,),
              "rho_prev": (n_rows,), "iteration": (), "ub": (n_rows, g),
              "means_t": (dim, k), "moving": (k,), "t_th": (), "v_th": (),
              "lam": (k, dim), "mult": (), "cand": (), "changed": (),
              "assign_work": (n_rows,), "ub_work": (n_rows, g),
              "m_mean": (k, dim), "counts": (k,)}
    tree, _ = restore_checkpoint(directory, {
        name: np.broadcast_to(np.int8(0), s) for name, s in shapes.items()})
    t = lambda a, dt: torch.from_numpy(np.array(a, dt, order="C")).to(dev)
    f32, i32 = np.float32, np.int32
    params = StructuralParams(int(tree["t_th"]), float(tree["v_th"]))
    index = build_mean_index(t(tree["means_t"], f32), params,
                             moving=t(tree["moving"], np.bool_))
    state = KMeansState(index=index, assign=t(tree["assign"], i32),
                        rho_self=t(tree["rho_self"], f32),
                        rho_self_prev=t(tree["rho_prev"], f32),
                        iteration=int(tree["iteration"]),
                        ub=t(tree["ub"], f32))
    cursor = tuple(extra["cursor"])
    mode = extra.get("algo_mode", "full")
    work = _EpochWork(
        assign=t(tree["assign_work"], i32), ub=t(tree["ub_work"], f32),
        acc=[t(tree[name], np.int64) for name in ("mult", "cand",
                                                  "changed")],
        lam=(t(tree["lam"].T, f32) if mode == "full" and cursor[1] > 0
             else None))
    m_mean = counts = None
    if mode == "minibatch":
        m_mean, counts = t(tree["m_mean"].T, f32), t(tree["counts"], f32)
    return (state, work, m_mean, counts, cursor, list(extra["history"]),
            mode)


def streaming_fit(store, *, k: int, algo: str = "esicp", params="auto",
                  algo_mode: str = "full", batch_size: int = 4096,
                  max_iter: int = 60, est_grid: EstGrid | None = None,
                  est_iters=(1, 2), seed: int = 0, seed_rows=None, df=None,
                  prefetch_depth: int = 2, checkpoint_dir: str | None = None,
                  checkpoint_every: int = 0, resume: bool = False,
                  device="cuda", keep_trajectory: bool = False,
                  tune: str = "off", tune_budget=None) -> LloydResult:
    """Lloyd over a :class:`repro_torch.sparse.store.DocStore` on
    ``device``, the chunks streamed through the prefetcher.

    algo_mode='full': the exact Lloyd epoch chunk by chunk — assignment
        (each chunk's dead tail rows trimmed) and λ_t accumulated through
        ``segment_update``'s ``init`` (the same additions in the same order
        as one launch), then the index rebuild, a ρ_self pass over the
        chunks and the drift-loosened bounds.  It equals ``lloyd_fit`` on
        the resident corpus from the same seed rows bit for bit: the
        assignment after every iteration, ρ_self, the means and every
        history field but ``elapsed_s``.
    algo_mode='minibatch': Sculley-style streaming k-means — exact
        nearest-centroid assignment per chunk and per-centre running means
        (kept transposed (D, K) and updated in place); ``algo``,
        ``params`` and ``est_iters`` do not apply.

    EstParams (full mode) reads the whole store
    (:func:`repro_torch.core.estparams.estimate_params_store`).

    The result's ``passes`` holds each iteration's seconds by pass
    (assignment pass, index rebuild, ρ pass, bounds, EstParams) and its
    ``prefetch`` the host's waits on chunks.

    Checkpointing: with ``checkpoint_dir``, a snapshot in ``repro``'s
    format commits every ``checkpoint_every`` chunks inside the epoch (0:
    none) and at every epoch boundary; ``resume=True`` continues from the
    latest one (the port's or ``repro``'s), mid-epoch ones included.

    ``tune`` / ``tune_budget`` as in :func:`lloyd_fit`, per chunk: the
    first pass over a chunk resolves its tuned config and later epochs
    reuse it; chunks of one store share a corpus signature, so the first
    chunk's search is every later chunk's cache hit.
    """
    from repro_torch.sparse.store import ChunkPrefetcher

    if algo_mode not in ("full", "minibatch"):
        raise ValueError(f"algo_mode must be 'full' or 'minibatch', "
                         f"got {algo_mode!r}")
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algo!r}; one of "
                         f"{sorted(ALGORITHMS)}")
    dev = resolve_device(device)
    est_grid = est_grid or EstGrid()
    est_iters = tuple(est_iters)
    n, c, n_rows = store.n_docs, store.chunk_size, store.n_rows
    n_chunks = store.n_chunks
    bs = max(1, min(batch_size, c))
    minibatch = algo_mode == "minibatch"
    estimating = not minibatch and params == "auto" and bool(est_iters)
    if df is None and estimating:
        df = store.df
    if df is not None:
        df = torch.as_tensor(np.asarray(df.cpu() if torch.is_tensor(df)
                                        else df)).to(dev, torch.int32)
    bk = KernelBackend()
    chunk_bks = {}

    def chunk_bk(ci: int, cdocs: SparseDocs) -> KernelBackend:
        """The backend of chunk ``ci``: tuned at its first pass."""
        if ci not in chunk_bks:
            chunk_bks[ci] = bk.prepare(cdocs, k=k, tune=tune,
                                       tune_budget=tune_budget)
        return chunk_bks[ci]

    if resume:
        if not checkpoint_dir:
            raise ValueError("resume=True needs checkpoint_dir")
        (state, work, m_mean, counts, (start_epoch, start_chunk), history,
         ckpt_mode) = _stream_ckpt_restore(checkpoint_dir, n_rows=n_rows,
                                           k=k, dim=store.dim, dev=dev)
        if ckpt_mode != algo_mode:
            # The shapes alias across modes, so a silent continue would
            # finish with wrong labels.
            raise ValueError(
                f"checkpoint under {checkpoint_dir} was written by an "
                f"algo_mode={ckpt_mode!r} fit; cannot resume it with "
                f"algo_mode={algo_mode!r}")
    else:
        state = init_state_from_store(
            store, k, initial_params(None if minibatch else params,
                                     store.dim),
            seed=seed, seed_rows=seed_rows, device=dev)
        m_mean = state.index.means_t.clone() if minibatch else None
        counts = (torch.zeros((k,), dtype=torch.float32, device=dev)
                  if minibatch else None)
        work = _EpochWork.start(state)
        history = []
        start_epoch, start_chunk = 1, 0

    def maybe_ckpt(r, next_chunk, *, force=False):
        if not checkpoint_dir:
            return
        if not (force or (checkpoint_every and next_chunk
                          and next_chunk % checkpoint_every == 0)):
            return
        _stream_ckpt_save(
            checkpoint_dir, step=(r - 1) * (n_chunks + 1) + next_chunk,
            state=state, work=work, m_mean=m_mean, counts=counts,
            cursor=(r, next_chunk), history=history, algo_mode=algo_mode,
            k=k, dim=store.dim)

    def feed(first: int = 0):
        """(prefetcher, its pass, started): the reads begin at once."""
        pf = ChunkPrefetcher(store, depth=prefetch_depth,
                             order=range(first, n_chunks), device=dev)
        return pf, iter(pf)

    trajectory = [] if keep_trajectory else None
    prefetch = {"wait_s": [], "late": []}
    passes = []
    converged = False
    next_a = None                # the next epoch's assignment pass, begun
    r = start_epoch - 1
    for r in range(start_epoch, max_iter + 1):
        t0 = time.perf_counter()
        clock = _PassClock(dev)
        clock.mark("start")
        first = start_chunk if r == start_epoch else 0
        if first == 0:
            work = _EpochWork.start(state)
        xstate = state.xstate
        extra = {} if minibatch else _epoch_extra(algo, state.index)

        # ---- pass A: assignment + λ_t (full) or centre updates, by chunk
        pf_a, chunks = next_a or feed(first)
        next_a = None
        for ci, cdocs in chunks:
            s0, m = ci * c, store.n_valid(ci)
            cdocs = cdocs.slice_rows(0, m)
            sl = slice(s0, s0 + m)
            cbk = chunk_bk(ci, cdocs)
            if minibatch:
                a_new, ch, index = _minibatch_chunk(
                    cbk, cdocs, state.index, state.assign[sl], m_mean, counts,
                    k=k, bs=bs)
                work.assign[sl] = a_new
                work.acc[1] += m * k
                work.acc[2] += ch
                # the evolving centres are the state a checkpoint saves
                state = dataclasses.replace(state, index=index)
            else:
                _assign_rows(algo, cbk, cdocs, state.index, state.assign[sl],
                             state.rho_self[sl], xstate[sl], state.ub[sl],
                             bs, extra, work.assign[sl], work.ub[sl],
                             work.acc)
                work.lam = bk.accumulate_means(cdocs, work.assign[sl], k=k,
                                               init=work.lam)
            maybe_ckpt(r, ci + 1)

        clock.mark("assignment pass")

        # ---- the update: index (full), ρ_self pass, bounds --------------
        # The ρ pass's reads start now, under the index rebuild.
        pf_r, chunks = feed()
        if minibatch:
            index = state.index
        else:
            means_t = normalized_means(work.lam, state.index.means_t)
            work.lam = None
            index = build_mean_index(
                means_t, state.index.params,
                moving=moving_flags(work.assign, state.assign, k))
        clock.mark("index rebuild")
        rho = torch.zeros((n_rows,), dtype=torch.float32, device=dev)
        for ci, cdocs in chunks:
            s0, m = ci * c, store.n_valid(ci)
            rho[s0:s0 + m] = bk.self_sims(cdocs.slice_rows(0, m),
                                          work.assign[s0:s0 + m],
                                          index.means_t)
        clock.mark("ρ pass")
        if r < max_iter:        # its reads run under the rest of the epoch
            next_a = feed()
        # Minibatch never reads the bounds (exact assignment): carried.
        ub = (state.ub if minibatch else
              drift_loosen(work.ub, group_drift(index.means_t,
                                                state.index.means_t)))
        state = KMeansState(index=index, assign=work.assign, rho_self=rho,
                            rho_self_prev=state.rho_self,
                            iteration=state.iteration + 1, ub=ub)
        clock.mark("bounds")
        if estimating and r in est_iters:
            new_params, _ = estimate_params_store(
                store, df, state.index.means_t, state.rho_self, k=k,
                grid=est_grid, prefetch_depth=prefetch_depth)
            state = dataclasses.replace(
                state, index=state.index.with_params(new_params))
            clock.mark("EstParams")

        history.append(_history_row(r, n, k, *work.acc, state,
                                    state.rho_self[:n], t0))
        passes.append(clock.seconds())
        prefetch["wait_s"].append(pf_a.wait_s + pf_r.wait_s)
        prefetch["late"].append(pf_a.late + pf_r.late)
        if keep_trajectory:
            trajectory.append(state.assign[:n].cpu())
        maybe_ckpt(r + 1, 0, force=True)
        if history[-1]["n_changed"] == 0:
            converged = True
            break
    if next_a is not None:
        next_a[1].close()

    state = dataclasses.replace(
        state, assign=state.assign[:n], rho_self=state.rho_self[:n],
        rho_self_prev=state.rho_self_prev[:n], ub=state.ub[:n])
    return LloydResult(state=state, assign=state.assign, history=history,
                       params=state.index.params, converged=converged,
                       n_iter=len(history), trajectory=trajectory,
                       cursor=None if converged else (r + 1, 0),
                       prefetch=prefetch, passes=passes,
                       tuned=next((b.tuned for b in chunk_bks.values()
                                   if b.tuned is not None), None))
