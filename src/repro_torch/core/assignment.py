"""Assignment step (counterpart of ``repro.core.assignment``) for the
ported algorithms: ``mivi`` (Alg. 1) and ``esicp`` (Algs. 2–3).

Exactness: every algorithm returns the same assignments as MIVI from the
same state; the filters change only Mult and |Z_i|, counted as the paper
counts them.  Tie rule (``repro``'s ``_finalize``): a centroid must
strictly beat ρ_self, and among equal best scores the lowest centroid id
wins (``torch.argmax`` returns the first maximum).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.backends import col_ok_mask
from repro_torch.core.meanindex import MeanIndex
from repro_torch.core.update import n_ub_groups
from repro_torch.sparse.matrix import SparseDocs


@dataclasses.dataclass(frozen=True)
class AssignResult:
    assign: torch.Tensor        # (B,) int32 — new a(i)
    rho: torch.Tensor           # (B,) float32 — similarity to the winner
    n_candidates: torch.Tensor  # (B,) int32 — |Z_i|
    mult: torch.Tensor          # () int64 — multiply-adds the CPU algo executes
    changed: torch.Tensor       # (B,) bool
    ub: torch.Tensor            # (B, G) float32 — bounds, passed through


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


def default_ub(rho_self: torch.Tensor, k: int) -> torch.Tensor:
    """(B, G) 'no bound known' upper bounds: +inf."""
    return torch.full((rho_self.shape[0], n_ub_groups(k)), torch.inf,
                      dtype=torch.float32, device=rho_self.device)


def _mivi(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    """Alg. 1 — exact scan of the mean-inverted index, no filters."""
    ub = default_ub(rho_self, index.k) if ub is None else ub
    out = bk.accumulate(docs, index, torch.zeros_like(xstate), mode="exact")
    assign, rho = _finalize(out["sims"], prev_assign, rho_self)
    n_cand = torch.full_like(assign, index.k)
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
    # Verification cost: |Z_i| exact Region-3 partials of (ntH)_i mults each.
    verify = (n_cand.long() * _nt_tail(docs, index.params.t_th)).sum()
    return AssignResult(assign, rho, n_cand, out["mult"] + verify,
                        assign != prev_assign, ub)


def _esicp(bk, docs, index, prev_assign, rho_self, xstate, ub=None):
    return _es_core(bk, docs, index, prev_assign, rho_self, xstate, ub)


ALGORITHMS = {"mivi": _mivi, "esicp": _esicp}


def assign_batch(algo: str, backend, docs: SparseDocs, index: MeanIndex,
                 prev_assign: torch.Tensor, rho_self: torch.Tensor,
                 xstate: torch.Tensor, ub=None) -> AssignResult:
    """One assignment step over a batch of objects."""
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown or unported algorithm {algo!r}; one of "
                         f"{sorted(ALGORITHMS)}")
    return ALGORITHMS[algo](backend, docs, index, prev_assign, rho_self,
                            xstate, ub)
