"""Lloyd-iteration driver (counterpart of ``repro.core.lloyd.lloyd_fit``).

Each iteration: an assignment epoch over row batches (``assign_batch``),
the update step, and — at the EstParams iterations (1–2 by default) — a
new (t_th, v_th).  It stops when no assignment changed or at ``max_iter``,
the stop rule of ``repro``'s prologue + ``lax.while_loop``, and records
the same history rows.

The loop is plain Python; its one host read per iteration brings the
diagnostics (Mult, |Z| sum, #changed, objective, n_moving) across together,
and that read also ends the iteration's device work, so ``elapsed_s`` is
the iteration's wall time.  ``repro`` pads N to a batch multiple with dead
rows; here the last batch is simply shorter, which changes nothing (dead
rows contribute nothing to any diagnostic).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core.assignment import assign_batch
from repro_torch.core.backends import KernelBackend
from repro_torch.core.estparams import EstGrid, estimate_params
from repro_torch.core.meanindex import StructuralParams, region3_sketch
from repro_torch.core.update import KMeansState, init_state, update_step
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


def _epoch(algo: str, bk, docs: SparseDocs, state: KMeansState, bs: int):
    """One assignment epoch over row batches -> (assign, ub, mult, cand,
    changed), the last three as device scalars."""
    n = docs.n_docs
    dev = docs.device
    assign = torch.empty_like(state.assign)
    ub = torch.empty_like(state.ub)
    mult = torch.zeros((), dtype=torch.int64, device=dev)
    cand = torch.zeros((), dtype=torch.int64, device=dev)
    changed = torch.zeros((), dtype=torch.int64, device=dev)
    xstate = state.xstate
    # bounds-esicp's Region-3 mean sketch depends on the index alone: one
    # per epoch, not one per batch.
    extra = ({"r3_sketch": region3_sketch(state.index)}
             if algo == "bounds-esicp" else {})
    for s in range(0, n, bs):
        e = min(s + bs, n)
        res = assign_batch(algo, bk, docs.slice_rows(s, bs), state.index,
                           state.assign[s:e], state.rho_self[s:e],
                           xstate[s:e], state.ub[s:e], **extra)
        assign[s:e] = res.assign
        ub[s:e] = res.ub
        mult += res.mult
        cand += res.n_candidates.sum(dtype=torch.int64)
        changed += res.changed.sum(dtype=torch.int64)
    return assign, ub, mult, cand, changed


def lloyd_fit(docs: SparseDocs, *, k: int, algo: str = "esicp",
              params="auto", batch_size: int = 4096, max_iter: int = 60,
              est_grid: EstGrid | None = None, est_iters=(1, 2),
              seed: int = 0, seed_rows=None, df: torch.Tensor | None = None,
              device="cuda", keep_trajectory: bool = False) -> LloydResult:
    """Single-host Lloyd fit on ``device`` (docs are moved there).

    algo:      one of ``repro_torch.core.assignment.ALGORITHMS``: 'mivi',
               'icp', 'es', 'esicp', 'ta-icp', 'cs-icp', 'bounds', 'sketch',
               'bounds-esicp'.  Every mode gives MIVI's assignments; they
               differ in Mult, |Z| and the maintained bounds.
    params:    'auto' (EstParams at ``est_iters``), a StructuralParams for
               fixed thresholds, or None (trivial).
    seed_rows: optional (K,) document indices for the initial centroids
               (else drawn from ``seed`` with a torch.Generator).
    """
    dev = resolve_device(device)
    docs = docs.to(dev).validate()
    est_grid = est_grid or EstGrid()
    est_iters = tuple(est_iters)
    n = docs.n_docs
    if df is None:
        df = docs.df
    bk = KernelBackend()
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
        # The iteration's one host read: every diagnostic crosses together
        # (float64 holds these counts exactly below 2^53).
        mult_h, cand_h, changed_h, n_moving, objective = torch.stack([
            mult.double(), cand.double(), changed.double(),
            state.index.n_moving.double(), state.rho_self.double().sum(),
        ]).tolist()
        p = state.index.params
        history.append({
            "iteration": r,
            "mult": int(mult_h),
            "n_candidates": int(cand_h),
            "cpr": cand_h / (n * k),
            "n_changed": int(changed_h),
            "objective": objective,
            "n_moving": int(n_moving),
            "elapsed_s": time.perf_counter() - t0,
            "t_th": p.t_th,
            "v_th": p.v_th,
        })
        if keep_trajectory:
            trajectory.append(state.assign.cpu())
        if history[-1]["n_changed"] == 0:
            converged = True
            break

    return LloydResult(state=state, assign=state.assign, history=history,
                       params=state.index.params, converged=converged,
                       n_iter=len(history), trajectory=trajectory)
