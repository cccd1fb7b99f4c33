"""Cluster serving engine: classify/refit against a frozen MeanIndex
(counterpart of ``repro.serve.engine``).

:class:`ClusterEngine` serves a fitted model's frozen index: ``classify``
is the shared classify path (:func:`repro_torch.cluster.classify_docs`),
and ``refit`` rebuilds the index from a fresh corpus, resident SparseDocs
or a chunk-streamed DocStore, without a training fit: per round, classify
against the current index, then the update phase (``segment_update`` for
the cluster sums, with ``init=`` chunk after chunk over a store,
``normalized_means``, ``build_mean_index`` and ``rho_gather`` for each
document's ρ against the rebuilt means).  ``from_model`` / ``to_model``
close the train → serve → refit loop on the one FittedModel artifact, and
``serve()`` lifts it into the continuous-batching service
(:mod:`repro_torch.serve.server`).  A two-level model classifies through
its coarse level (:func:`repro_torch.cluster.classify_docs_routed`) and
has no refit.

A refit rebinds the engine's index to new tensors and never writes the
old ones, so a server still serving the old model is not disturbed.  At
most two (D, K) matrices are alive in a refit: the current means and the
new sums.  This module imports nothing of the LM path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.cluster.classify import (_store_tiles, classify_docs,
                                          classify_docs_routed)
from repro_torch.core.backends import KernelBackend
from repro_torch.core.meanindex import build_mean_index, normalized_means
from repro_torch.sparse.store import ChunkPrefetcher, DocStore


class ClusterEngine:
    """Classify documents against a frozen MeanIndex (serving mode).

    model:      the :class:`repro_torch.cluster.FittedModel` to serve; a
                :class:`TwoLevelFittedModel` classifies through its coarse
                level (``classify_docs_routed``) and refuses ``refit``.
    device:     ``"cuda"`` (default; raises without a GPU) or ``"cpu"``;
                the index is moved there.
    batch_size: rows per classify batch.
    """

    def __init__(self, model, *, device="cuda", batch_size: int = 4096):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self._source = model
        self.index = model.index.to(self.device)
        self.batch_size = batch_size
        self._last_assign = None
        self._last_rho = None

    @classmethod
    def from_model(cls, model, *, device="cuda",
                   batch_size: int = 4096) -> ClusterEngine:
        """The serving runtime over a FittedModel artifact (train→serve)."""
        return cls(model, device=device, batch_size=batch_size)

    def to_model(self):
        """The engine's current index as a FittedModel (serve→refit): after
        ``refit`` it carries the rebuilt index and the last refit's
        membership and ρ, ready to ``save`` or to hot-swap."""
        if self._last_assign is None:
            return dataclasses.replace(self._source, index=self.index)
        return dataclasses.replace(self._source, index=self.index,
                                   labels=self._last_assign,
                                   rho_self=self._last_rho)

    def serve(self, *, name: str = "default", **server_kw):
        """A running :class:`repro_torch.serve.ClusterServer` on this
        engine's device hosting its artifact under ``name``; extra kwargs
        reach the server (``max_live_batches``, ``batch_timeout_s``, …).
        Callers own the server's lifecycle (``close()`` / ``with``)."""
        from repro_torch.serve.server import ClusterServer

        server = ClusterServer(device=self.device, **server_kw)
        try:
            server.load(name, self.to_model())
        except BaseException:
            server.close()
            raise
        return server

    def classify(self, docs, *, n_probe: int | None = None):
        """docs: SparseDocs | DocStore -> (assign (N,) int32, sims (N,)
        float32) on the engine's device, the same path as
        ``FittedModel.predict``.  A two-level model routes through its
        coarse level, ``n_probe`` overriding its probe width for this call;
        a flat model takes no ``n_probe``."""
        if self._two_level() is not None:
            return classify_docs_routed(self._two_level(), docs,
                                        n_probe=n_probe,
                                        batch_size=self.batch_size,
                                        device=self.device)
        if n_probe is not None:
            raise ValueError("n_probe only applies to an engine serving a "
                             "two-level model")
        return classify_docs(self.index, docs, batch_size=self.batch_size,
                             device=self.device)

    def _two_level(self):
        """The served model when it is a two-level one, else None."""
        return (self._source if getattr(self._source, "coarse_index", None)
                is not None else None)

    def _rebuild(self, lam_t: torch.Tensor) -> None:
        """λ_t (D, K) cluster sums -> a fresh index, in place of λ_t (every
        centroid moving; an empty cluster keeps its centroid)."""
        self.index = build_mean_index(
            normalized_means(lam_t, self.index.means_t), self.index.params)

    def refit(self, docs, *, n_iter: int = 1):
        """Rebuild the frozen index from a fresh corpus, ``n_iter`` rounds
        of classify → update phase.  ``docs`` is resident SparseDocs or a
        DocStore (streamed chunk by chunk, equal to the resident refit bit
        for bit).  Empty clusters keep their centroid, so a small refit
        batch cannot wipe out the index.

        Returns (assign (N,) int32, rho (N,) float32) on the engine's
        device: the membership the last rebuild consumed (classified
        against the pre-rebuild index, the Lloyd convention) and each
        document's ρ against the rebuilt means.  A two-level model
        refuses: a flat rebuild would move its fine means out from under
        the frozen coarse level.
        """
        if self._two_level() is not None:
            raise NotImplementedError(
                "refit is not supported on a two-level model: the flat "
                "update phase cannot maintain the coarse level; run a fresh "
                "fit with ClusterConfig(coarse_k=...) and hot-swap it")
        if isinstance(docs, DocStore):
            return self._refit_store(docs, n_iter=n_iter)
        if docs.n_docs == 0:
            raise ValueError("refit needs a non-empty corpus")
        docs = docs.to(self.device).validate()
        bk, k = KernelBackend(), self.index.k
        for _ in range(max(n_iter, 1)):
            assign, _ = self.classify(docs)
            self._rebuild(bk.accumulate_means(docs, assign, k=k))
        rho = bk.self_sims(docs, assign, self.index.means_t)
        self._last_assign, self._last_rho = assign, rho
        return assign, rho

    def _refit_store(self, store: DocStore, *, n_iter: int = 1):
        """Chunk-streamed refit: per round, one prefetched pass classifies
        each chunk against the pre-round index and adds its cluster sums
        onto λ_t (``segment_update`` with ``init=`` after the first chunk),
        the index rebuilds once from λ_t, and a second pass computes ρ
        against the rebuilt means.  Only the (N,) assignment stays on the
        device between the passes."""
        dev, bk, k = self.device, KernelBackend(), self.index.k
        c = store.chunk_size
        bs, trim = _store_tiles(store, self.batch_size)
        assign = torch.empty((store.n_docs,), dtype=torch.int32, device=dev)
        for _ in range(max(n_iter, 1)):
            lam_t = None
            for ci, cdocs in ChunkPrefetcher(store, device=dev):
                cdocs = trim(ci, cdocs)
                a, _ = classify_docs(self.index, cdocs, batch_size=bs)
                assign[ci * c:ci * c + cdocs.n_docs] = a
                lam_t = bk.accumulate_means(cdocs, a, k=k, init=lam_t)
            self._rebuild(lam_t)
        rho = torch.empty((store.n_docs,), dtype=torch.float32, device=dev)
        for ci, cdocs in ChunkPrefetcher(store, device=dev):
            cdocs = trim(ci, cdocs)
            s = slice(ci * c, ci * c + cdocs.n_docs)
            rho[s] = bk.self_sims(cdocs, assign[s], self.index.means_t)
        self._last_assign, self._last_rho = assign, rho
        return assign, rho
