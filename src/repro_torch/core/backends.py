"""The kernel backend: who produces the assignment and update accumulators.

Counterpart of ``repro.core.backends``.  The algorithms in
:mod:`repro_torch.core.assignment` are selection logic over a few
accumulators; :class:`KernelBackend` produces them through
:mod:`repro_torch.kernels.ops`, which sends CUDA tensors to the CUDA
kernels and CPU tensors to their plain versions.  So one backend serves the
card and the CPU tests, and which path ran is visible in the ops counters.

The port's kernels need no epoch-invariant plan: they plan per launch.
What ``prepare`` carries over a fit is the autotuner's winner
(:mod:`repro_torch.tune`): it returns the backend the fit runs, holding
the tuned config that ``accumulate`` passes to the two gathers.
``repro``'s TAAT ``reference_scan`` is not ported yet.

Mult is counted exactly, in int64: ``counts`` are int32 per (object,
centroid) and ``mult`` is their int64 sum over the ICP-allowed columns
(``repro`` sums float32, which agrees below 2^24).
"""
from __future__ import annotations

import torch

from repro_torch.core.meanindex import MeanIndex, doc_sketch
from repro_torch.kernels import ops
from repro_torch.sparse.matrix import SparseDocs


def col_ok_mask(index: MeanIndex, xstate: torch.Tensor) -> torch.Tensor:
    """(B, K) — centroids the ICP filter allows: moving ones always;
    invariant ones only for objects that are not 'more similar' (Eq. 5)."""
    return index.moving[None, :] | ~xstate[:, None]


class KernelBackend:
    """Accumulators from the hand-written kernels (plain versions on CPU).

    ``accumulate`` returns

      mode 'exact' -> {sims, mult}                  one sparse_sim launch
      mode 'esicp' -> {sims, rho12, y, mult}        one esicp_gather launch
      mode 'ta'    -> {sims, rho12, y, mult}        one launch of its
                      per-row-threshold variant (``v_ta`` (B,) required)
      mode 'cs'    -> {sims, rho1, sq, mult}        three sparse_sim launches

    plus ``counts`` (the raw per-pair visited counts of the mode's exact
    region, without the ICP mask) when ``with_counts``.  ``diag=False``
    skips the counts and returns mult = 0.
    """

    name = "kernel"

    def __init__(self, tuned=None):
        # The gathers' tile settings (repro_torch.tune.TunedConfig), or
        # None for the defaults.
        self.tuned = tuned

    def prepare(self, docs: SparseDocs, *, k: int | None = None,
                tune: str = "off", tune_budget=None) -> KernelBackend:
        """The backend a fit over ``docs`` runs.  ``tune`` 'off': this one.
        'cached' / 'search': one carrying
        :func:`repro_torch.tune.ensure_tuned`'s config for the corpus (the
        cached winner; 'search' runs the pruned search on a miss under
        ``tune_budget``), or None where there is none, always on the CPU
        (the plain versions have no tiles)."""
        if tune == "off":
            return self
        from repro_torch.tune.search import ensure_tuned

        return KernelBackend(ensure_tuned(docs, k=k, mode=tune,
                                          budget=tune_budget))

    def accumulate(self, docs: SparseDocs, index: MeanIndex,
                   xstate: torch.Tensor, *, mode: str, v_ta=None,
                   diag: bool = True, with_counts: bool = False) -> dict:
        if with_counts and not diag:
            raise ValueError("with_counts requires diag=True")
        if (mode == "ta") != (v_ta is not None):
            raise ValueError("mode 'ta' and only it takes v_ta")
        means_t = index.means_t
        t_th = index.params.t_th
        tuned = self.tuned
        if mode in ("exact", "cs"):
            sims, counts = ops.sparse_sim(docs.ids, docs.vals, means_t,
                                          with_counts=diag, tuned=tuned)
            out = {"sims": sims}
            if mode == "cs":
                # Head-only partial: masking the object side (ids < t_th)
                # gives the sums of masking the mean rows.
                head = torch.where(docs.ids < t_th, docs.vals, 0.0)
                out["rho1"], _ = ops.sparse_sim(docs.ids, head, means_t,
                                                tuned=tuned)
                # Σ over slots of m², with repro's dead-slot quirk: the
                # substituted values make a dead slot (id 0) live iff
                # t_th == 0, as its reference scan counts it.
                tail_ones = (docs.ids >= t_th).to(torch.float32)
                out["sq"], _ = ops.sparse_sim(docs.ids, tail_ones, means_t,
                                              square=True)
        elif mode in ("esicp", "ta"):
            rho12, y, sims, counts = ops.esicp_gather(
                docs.ids, docs.vals, means_t, t_th, index.params.v_th,
                with_counts=diag, v_ta=v_ta, tuned=tuned)
            out = {"sims": sims, "rho12": rho12, "y": y}
        else:
            raise ValueError(f"unknown mode {mode!r}; 'exact', 'esicp', "
                             f"'ta' or 'cs'")
        if diag:
            ok = col_ok_mask(index, xstate)
            out["mult"] = torch.where(ok, counts, 0).sum(dtype=torch.int64)
            if with_counts:
                out["counts"] = counts
        else:
            out["mult"] = torch.zeros((), dtype=torch.int64,
                                      device=means_t.device)
        return out

    def sketch_sim(self, docs: SparseDocs, index: MeanIndex, *,
                   doc_sk: torch.Tensor | None = None) -> torch.Tensor:
        """(B, K) sketch similarities (an upper bound on the exact cosine
        for non-negative data); ``doc_sk`` is the batch's doc sketch when
        the caller has it already."""
        if doc_sk is None:
            doc_sk = doc_sketch(docs.ids, docs.vals, index.dim)
        return ops.sketch_sim(doc_sk, index.sketch_t)

    def es_filter(self, rho12, y, rho_self, col_ok, v_th):
        """ES bound (Eq. 4) -> (survivor mask (B, K) bool, |Z_i| (B,) int32)."""
        return ops.esicp_filter(rho12, y, rho_self, col_ok, v_th)

    def accumulate_means(self, docs, assign, *, k: int, init=None):
        """(D, K) transposed cluster sums λ_t of ``docs``' live tuples;
        assignments outside [0, K) contribute nothing.  ``init`` (D, K) is
        added to in place (a chunked caller's running λ_t)."""
        return ops.segment_update(assign, docs, k=k, init=init)

    def self_sims(self, docs, assign, means_t):
        """(B,) ρ of ``docs``' live tuples against each object's own
        centroid (0 outside [0, K))."""
        return ops.rho_gather(assign, docs.ids, docs.vals, means_t,
                              nnz=docs.nnz)
