"""Update step (paper Alg. 6) + clustering state (counterpart of
``repro.core.update``).

The update accumulates the cluster sums λ (the ``segment_update`` kernel,
written transposed so the new means are λ normalised in place), rebuilds
the index statistics and moving flags, and refreshes every object's
self-similarity ρ_self against its new centroid (the ``rho_gather``
kernel).  Invariant-centroid detection uses exact set semantics: a centroid
moved iff an object entered or left its cluster.

At most two (D, K) matrices are alive at once: the previous means and the
new λ/means.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.core.meanindex import (MeanIndex, StructuralParams,
                                        build_mean_index, column_dots,
                                        normalized_means)
from repro_torch.kernels.ref import sqrt_rn
from repro_torch.sparse.matrix import SparseDocs


@dataclasses.dataclass(frozen=True)
class KMeansState:
    index: MeanIndex
    assign: torch.Tensor         # (N,) int32
    rho_self: torch.Tensor       # (N,) float32 — ρ_{a(i)} vs the current means
    rho_self_prev: torch.Tensor  # (N,) float32 — the previous refresh
    iteration: int
    ub: torch.Tensor             # (N, G) float32 — drift-loosened per-group
    #                              bounds (bounds modes; +inf = unknown)

    @property
    def xstate(self) -> torch.Tensor:
        """Eq. (5): the refreshed self-similarity did not decrease.  False
        on the first two iterations (no history)."""
        if self.iteration < 2:
            return torch.zeros_like(self.rho_self, dtype=torch.bool)
        return self.rho_self >= self.rho_self_prev


# Additive slack keeping the drift-loosened bound a true upper bound under
# float32 rounding of the arccos/cos round trip.
UB_DRIFT_EPS = 1e-5

# Per-object bounds are kept per centroid group: one per center up to
# UB_GROUPS centers, then ceil(k / UB_GROUPS)-wide contiguous tiers.
UB_GROUPS = 16


def ub_group_size(k: int) -> int:
    return -(-k // min(k, UB_GROUPS))


def n_ub_groups(k: int) -> int:
    return -(-k // ub_group_size(k))


def _in_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` evaluated in float64 and rounded to float32.  The float32
    arccos and cos of the CPU and of the card differ in the last bit for
    some inputs; rounded from float64 they agree (barring a float64 error
    that straddles a float32 rounding boundary)."""
    return fn(x.double()).to(torch.float32)


def ub_group_of(k: int, device=None) -> torch.Tensor:
    """(K,) int64 centroid id -> bound group (contiguous tiers)."""
    return torch.arange(k, device=device) // ub_group_size(k)


def max_center_drift(means_t_new: torch.Tensor,
                     means_t_old: torch.Tensor) -> torch.Tensor:
    """() float32 max_j angular drift arccos(<c_j_new, c_j_old>), from the
    row-chunked column dots (no (D, K) product temporary)."""
    dots = column_dots(means_t_new, means_t_old)
    return _in_f64(torch.arccos, torch.clamp(dots, -1.0, 1.0)).amax()


def group_drift(means_t_new: torch.Tensor, means_t_old: torch.Tensor, *,
                k: int | None = None, k0: int = 0) -> torch.Tensor:
    """(G,) float32 per-bound-group max angular drift arccos(<c_new, c_old>).

    The column dots are row-chunked (never a (D, K) product temporary) and
    summed in ``repro``'s order: near a dot of 1 the arccos turns one ulp
    into a drift of 3·10^-4, which the bounds modes would see.  A ragged
    final group pads with zero drift.  A mesh's centroid shard passes the
    global ``k`` and its columns' first id ``k0``: the groups it holds no
    column of get 0, for the max over the shards.
    """
    dots = column_dots(means_t_new, means_t_old)
    d = _in_f64(torch.arccos, torch.clamp(dots, -1.0, 1.0))
    k_loc = d.shape[0]
    k = k_loc if k is None else k
    gsz = ub_group_size(k)
    g = n_ub_groups(k)
    lo, hi = k0 // gsz, -(-(k0 + k_loc) // gsz)
    d = torch.nn.functional.pad(d, (k0 - lo * gsz, hi * gsz - k0 - k_loc))
    return torch.nn.functional.pad(d.view(hi - lo, gsz).amax(dim=1),
                                   (lo, g - hi))


def drift_loosen(ub: torch.Tensor, delta_max: torch.Tensor) -> torch.Tensor:
    """cos(max(0, θ − δ)) + UB_DRIFT_EPS for finite bounds, where
    θ = arccos(ub); non-finite bounds pass through.  Broadcasts a (N, G)
    bound against a (G,) drift."""
    theta = _in_f64(torch.arccos, torch.clamp(ub, -1.0, 1.0))
    loose = (_in_f64(torch.cos, torch.clamp(theta - delta_max, min=0.0))
             + UB_DRIFT_EPS)
    return torch.where(torch.isfinite(ub), loose, ub)


def moving_flags(assign: torch.Tensor, prev_assign: torch.Tensor,
                 k: int) -> torch.Tensor:
    """(K,) bool — a centroid moved iff an object entered or left it."""
    changed = (assign != prev_assign).to(torch.int32)
    moving = torch.zeros((k,), dtype=torch.int32, device=assign.device)
    moving.scatter_reduce_(0, assign.long(), changed, "amax")
    moving.scatter_reduce_(0, prev_assign.long(), changed, "amax")
    return moving.bool()


def update_step(docs: SparseDocs, assign: torch.Tensor,
                prev_assign: torch.Tensor, prev_state: KMeansState,
                params: StructuralParams, *, k: int, backend,
                ub: torch.Tensor | None = None) -> KMeansState:
    """New means, moving flags, refreshed ρ_self, loosened bounds.

    ``backend`` is a :class:`repro_torch.core.backends.KernelBackend`.
    ``ub`` is the assignment step's refreshed bound (None keeps the
    previous state's); either way it is loosened by this update's drift.
    """
    lam_t = backend.accumulate_means(docs, assign, k=k)
    means_t = normalized_means(lam_t, prev_state.index.means_t)
    index = build_mean_index(means_t, params,
                             moving=moving_flags(assign, prev_assign, k))
    rho_self = backend.self_sims(docs, assign, means_t)
    ub = prev_state.ub if ub is None else ub
    delta = group_drift(means_t, prev_state.index.means_t)
    return KMeansState(index=index, assign=assign, rho_self=rho_self,
                       rho_self_prev=prev_state.rho_self,
                       iteration=prev_state.iteration + 1,
                       ub=drift_loosen(ub, delta))


def draw_seed_rows(n_docs: int, k: int, *, seed: int = 0) -> torch.Tensor:
    """(K,) distinct document indices drawn with a seeded torch.Generator.

    ``repro`` draws with ``jax.random.choice``, which torch cannot
    reproduce; to start from ``repro``'s centroids pass its rows to
    :func:`init_state` instead.
    """
    if not 1 <= k <= n_docs:
        raise ValueError(f"k={k} seeds need 1 <= k <= n_docs={n_docs}")
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n_docs, generator=gen)[:k]


def seed_centroids(sel: SparseDocs, k: int) -> torch.Tensor:
    """(D, K) unit-norm transposed means from K seed documents."""
    means_t = torch.zeros((sel.dim, k), dtype=torch.float32,
                          device=sel.device)
    cols = torch.arange(k, device=sel.device)[:, None].expand_as(sel.ids)
    vals = torch.where(sel.row_mask(), sel.vals, 0.0)
    means_t.index_put_((sel.ids.long(), cols), vals, accumulate=True)
    norms = sqrt_rn(column_dots(means_t, means_t))
    return means_t.div_(torch.clamp(norms, min=1e-12))


def init_state_from_store(store, k: int, params: StructuralParams, *,
                          seed: int = 0, seed_rows=None,
                          device="cuda") -> KMeansState:
    """:func:`init_state` for a :class:`repro_torch.sparse.store.DocStore`:
    the same seed rows and centroids (the K rows gathered from their
    chunks on the host), with per-document arrays over every store row —
    real rows at ρ_self = -inf and ub = +inf, the dead tail rows at 0."""
    dev = resolve_device(device)
    pick = (draw_seed_rows(store.n_docs, k, seed=seed) if seed_rows is None
            else torch.as_tensor(seed_rows)).long().cpu()
    if pick.shape != (k,) or torch.unique(pick).numel() != k:
        raise ValueError(f"seed_rows must hold {k} distinct row indices")
    sel = store.gather_rows(pick.numpy(), device=dev)
    index = build_mean_index(seed_centroids(sel, k), params)
    n_rows = store.n_rows
    valid = torch.arange(n_rows, device=dev) < store.n_docs
    rho0 = torch.where(valid, -torch.inf, 0.0)
    ub = torch.where(valid, torch.inf, 0.0)[:, None].expand(
        n_rows, n_ub_groups(k)).contiguous()
    return KMeansState(
        index=index,
        assign=torch.zeros((n_rows,), dtype=torch.int32, device=dev),
        rho_self=rho0, rho_self_prev=rho0.clone(), iteration=0, ub=ub)


def init_state(docs: SparseDocs, k: int, params: StructuralParams, *,
               seed: int = 0, seed_rows: torch.Tensor | None = None
               ) -> KMeansState:
    """K distinct documents as the initial centroids.

    ``seed_rows`` (K,) picks the documents explicitly; otherwise they are
    drawn by :func:`draw_seed_rows` from ``seed``.
    """
    pick = (draw_seed_rows(docs.n_docs, k, seed=seed) if seed_rows is None
            else torch.as_tensor(seed_rows))
    pick = pick.to(docs.device, torch.long)
    if pick.shape != (k,) or torch.unique(pick).numel() != k:
        raise ValueError(f"seed_rows must hold {k} distinct row indices")
    sel = SparseDocs(docs.ids[pick], docs.vals[pick], docs.nnz[pick],
                     docs.dim)
    index = build_mean_index(seed_centroids(sel, k), params)
    n = docs.n_docs
    full = lambda v: torch.full((n,), v, dtype=torch.float32,
                                device=docs.device)
    return KMeansState(
        index=index,
        assign=torch.zeros((n,), dtype=torch.int32, device=docs.device),
        rho_self=full(-torch.inf),
        rho_self_prev=full(-torch.inf),
        iteration=0,
        ub=torch.full((n, n_ub_groups(k)), torch.inf, dtype=torch.float32,
                      device=docs.device),
    )
