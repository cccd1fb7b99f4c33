"""The kernel backend: who produces the assignment and update accumulators.

Counterpart of ``repro.core.backends``.  The algorithms in
:mod:`repro_torch.core.assignment` are selection logic over a few
accumulators; :class:`KernelBackend` produces them through
:mod:`repro_torch.kernels.ops`, which sends CUDA tensors to the CUDA
kernels and CPU tensors to their plain versions.  So one backend serves the
card and the CPU tests, and which path ran is visible in the ops counters.

The port's kernels need no epoch-invariant plan, so ``prepare`` returns
None.  ``repro``'s TAAT ``reference_scan`` is not ported yet.

Mult is counted exactly, in int64: ``counts`` are int32 per (object,
centroid) and ``mult`` is their int64 sum over the ICP-allowed columns
(``repro`` sums float32, which agrees below 2^24).
"""
from __future__ import annotations

import torch

from repro_torch.core.meanindex import MeanIndex
from repro_torch.kernels import ops
from repro_torch.sparse.matrix import SparseDocs


def col_ok_mask(index: MeanIndex, xstate: torch.Tensor) -> torch.Tensor:
    """(B, K) — centroids the ICP filter allows: moving ones always;
    invariant ones only for objects that are not 'more similar' (Eq. 5)."""
    return index.moving[None, :] | ~xstate[:, None]


class KernelBackend:
    """Accumulators from the hand-written kernels (plain versions on CPU).

    ``accumulate`` returns

      mode 'exact' -> {sims, mult}
      mode 'esicp' -> {sims, rho12, y, mult}

    plus ``counts`` (the raw per-pair visited counts of the mode's exact
    region, without the ICP mask) when ``with_counts``.  ``diag=False``
    skips the counts and returns mult = 0.
    """

    name = "kernel"

    def prepare(self, docs: SparseDocs, **_):
        return None

    def accumulate(self, docs: SparseDocs, index: MeanIndex,
                   xstate: torch.Tensor, *, mode: str, diag: bool = True,
                   with_counts: bool = False) -> dict:
        if with_counts and not diag:
            raise ValueError("with_counts requires diag=True")
        means_t = index.means_t
        if mode == "exact":
            sims, counts = ops.sparse_sim(docs.ids, docs.vals, means_t,
                                          with_counts=diag)
            out = {"sims": sims}
        elif mode == "esicp":
            rho12, y, sims, counts = ops.esicp_gather(
                docs.ids, docs.vals, means_t, index.params.t_th,
                index.params.v_th, with_counts=diag)
            out = {"sims": sims, "rho12": rho12, "y": y}
        else:
            raise ValueError(f"mode {mode!r} is not ported; 'exact' or "
                             f"'esicp'")
        if diag:
            ok = col_ok_mask(index, xstate)
            out["mult"] = torch.where(ok, counts, 0).sum(dtype=torch.int64)
            if with_counts:
                out["counts"] = counts
        else:
            out["mult"] = torch.zeros((), dtype=torch.int64,
                                      device=means_t.device)
        return out

    def es_filter(self, rho12, y, rho_self, col_ok, v_th):
        """ES bound (Eq. 4) -> (survivor mask (B, K) bool, |Z_i| (B,) int32)."""
        return ops.esicp_filter(rho12, y, rho_self, col_ok, v_th)

    def accumulate_means(self, ids, vals, assign, *, k: int, dim: int):
        """(D, K) transposed cluster sums λ_t; dead slots (vals 0) and
        assignments outside [0, K) contribute nothing."""
        return ops.segment_update(assign, ids, vals, k=k, d=dim)

    def self_sims(self, ids, vals, assign, means_t):
        """(B,) ρ against each object's own centroid (0 outside [0, K))."""
        return ops.rho_gather(assign, ids, vals, means_t)
