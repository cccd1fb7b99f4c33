"""Two-level IVF spherical k-means (counterpart of
``repro.cluster.two_level``).

1. **Coarse fit**: a flat fit at k = K_c through the flat strategies
   (``lloyd_fit`` for resident documents, ``streaming_fit`` for a
   DocStore).
2. **Partition** by coarse assignment: resident rows are gathered on the
   device (each keeps the corpus's padded width P, so ρ's summation order
   and every cell fit stay ``repro``'s); a DocStore splits into lazy
   :class:`repro_torch.sparse.store.SubsetStore` views.
3. **Fine fits**: per non-empty cell a flat fit at k_i centroids
   (:func:`_allocate_fine_k`, ∝ cell size, each cell >= 1 and <= its
   population), seeded with ``seed + c + 1``, under the corpus's *global*
   df.  An empty cell keeps its coarse mean as its one fine centroid.
4. **Nested artifact**: a :class:`TwoLevelFittedModel` over the fine means
   of all cells, cell after cell in one (D, K_eff) matrix, with global
   labels and ρ_self; classify routes through the coarse level
   (:func:`repro_torch.cluster.classify.classify_docs_routed`).

Memory: the fine means are written into one (D, K_eff) matrix allocated
once, each cell's block as its fit ends, and the coarse fit's state but
its index is dropped before the cell fits.  At the NYT widths (D 495,126,
K 10,000) a list of blocks and their concatenation would be two 19.8 GB
matrices at once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cluster.config import ClusterConfig
from repro_torch.cluster.model import TwoLevelFittedModel
from repro_torch.core.meanindex import StructuralParams, build_mean_index
from repro_torch.core.update import KMeansState, n_ub_groups
from repro_torch.sparse.matrix import SparseDocs
from repro_torch.sparse.store import DocStore, partition_store


def _allocate_fine_k(sizes, k: int) -> np.ndarray:
    """Fine clusters per coarse cell, (K_c,) int64: every cell >= 1 (an
    empty cell keeps its coarse mean), none over ``max(n_i, 1)``, Σ =
    min(k, Σ caps), the remainder spread ∝ cell size by largest remainder
    (ties in cell order)."""
    sizes = np.asarray(sizes, np.int64)
    cap = np.maximum(sizes, 1)
    alloc = np.ones(sizes.shape, np.int64)
    rem = int(min(int(k), int(cap.sum())) - alloc.sum())
    while rem > 0:
        room = cap - alloc
        w = np.where(room > 0, np.maximum(sizes, 1), 0).astype(np.float64)
        ideal = rem * w / w.sum()
        add = np.minimum(np.floor(ideal).astype(np.int64), room)
        if int(add.sum()) == 0:
            # Every floor is 0: the last units go to the largest
            # fractional shares that still have room.
            frac = np.where(room > 0, ideal, -1.0)
            take = np.argsort(-frac, kind="stable")[:rem]
            add = np.zeros_like(alloc)
            add[take[room[take] > 0]] = 1
        alloc += add
        rem -= int(add.sum())
    return alloc


def _gather_rows_docs(docs: SparseDocs, rows: torch.Tensor) -> SparseDocs:
    """A resident cell: the given rows at the corpus's padded width."""
    return SparseDocs(docs.ids[rows], docs.vals[rows], docs.nnz[rows],
                      docs.dim)


@dataclasses.dataclass
class TwoLevelResult:
    """What the estimator reads of a fit (``LloydResult``'s fields), the
    nested artifact it adopts (``model``), and each cell fit's history
    (``cell_histories``, empty for an empty cell; the coarse fit's is
    ``history``)."""

    model: TwoLevelFittedModel
    state: KMeansState
    assign: torch.Tensor
    history: list
    params: StructuralParams
    converged: bool
    n_iter: int
    cell_histories: list = dataclasses.field(default_factory=list)
    cursor: tuple | None = None
    trajectory: list | None = None
    # The cells share the autotuner's cache; the nested result carries no
    # one config (repro's two_level_fit leaves it None too).
    tuned: object = None

    @property
    def objective(self) -> float:
        return float(self.state.rho_self.double().sum())


def _flat_fit(sub_docs, sub_cfg: ClusterConfig, df, seed_rows):
    from repro_torch.cluster.strategies import resolve_strategy

    rows = (None if seed_rows is None
            else seed_rows(sub_docs.n_docs, sub_cfg.k, seed=sub_cfg.seed))
    return resolve_strategy(sub_cfg, sub_docs).fit(sub_docs, sub_cfg, df=df,
                                                   seed_rows=rows)


def two_level_fit(docs, config: ClusterConfig, df=None,
                  seed_rows=None) -> TwoLevelResult:
    """(docs, ClusterConfig(coarse_k=K_c)) -> TwoLevelResult on
    ``config.device``.

    ``docs`` is resident SparseDocs or a DocStore.  ``seed_rows``, when
    given, is a callable ``seed_rows(n_docs, k, seed=seed)`` -> (k,) rows
    that seeds the coarse fit and every cell fit (``repro``'s own
    ``repro.core.update.seed_rows`` makes the fit ``repro``'s); else each
    fit draws its rows from its seed.
    """
    dev = resolve_device(config.device)
    k_c = config.coarse_k
    is_store = isinstance(docs, DocStore)
    if not is_store:
        docs = docs.to(dev).validate()
    n, dim = docs.n_docs, docs.dim
    # The cells estimate their thresholds in global-df space: a cell's own
    # df would reorder the df-rank terms.  Read only when EstParams runs.
    need_df = (config.algo_mode == "full" and config.params == "auto"
               and bool(config.est_iters))
    if df is None and need_df:
        df = docs.df
    if df is not None and not is_store:
        df = torch.as_tensor(np.asarray(df.cpu() if torch.is_tensor(df)
                                        else df)).to(dev, torch.int32)

    # 1. The coarse fit; its state but the index is dropped before the
    # cell fits.
    coarse = _flat_fit(docs, config.replace(k=k_c, coarse_k=None, n_probe=1),
                       df, seed_rows)
    coarse_index = coarse.state.index
    coarse_labels = coarse.assign[:n].to(dev, torch.int64)
    history, n_iter = list(coarse.history), int(coarse.n_iter)
    all_converged = bool(coarse.converged)
    del coarse

    # 2. Partition, and 3. the fine fits.
    sizes = torch.bincount(coarse_labels, minlength=k_c).cpu().numpy()
    fine_k = _allocate_fine_k(sizes, config.k)
    starts = np.concatenate([[0], np.cumsum(fine_k)[:-1]])
    k_eff = int(fine_k.sum())
    if is_store:
        views = partition_store(docs, coarse_labels.cpu().numpy(), k_c,
                                chunk_size=config.chunk_size)
    else:
        order = torch.argsort(coarse_labels, stable=True)
    means_t = torch.empty((dim, k_eff), dtype=torch.float32, device=dev)
    labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    rho = torch.zeros((n,), dtype=torch.float32, device=dev)
    cell_meta, cell_histories = [], []
    row_start = 0
    for c in range(k_c):
        n_c, s0 = int(sizes[c]), int(starts[c])
        if n_c == 0:
            means_t[:, s0] = coarse_index.means_t[:, c]
            cell_meta.append({"n_docs": 0, "k": 1, "n_iter": 0,
                              "converged": True})
            cell_histories.append([])
            continue
        if is_store:
            cell_docs = views[c]
            rows = torch.from_numpy(cell_docs.rows).to(dev)
        else:
            rows = order[row_start:row_start + n_c]
            row_start += n_c
            cell_docs = _gather_rows_docs(docs, rows)
        k_i = int(fine_k[c])
        res = _flat_fit(cell_docs, config.replace(
            k=k_i, coarse_k=None, n_probe=1, seed=config.seed + c + 1,
            checkpoint_dir=None), df, seed_rows)
        means_t[:, s0:s0 + k_i] = res.state.index.means_t
        labels[rows] = s0 + res.assign[:n_c].to(dev)
        rho[rows] = res.state.rho_self[:n_c].to(dev)
        all_converged &= bool(res.converged)
        cell_meta.append({"n_docs": n_c, "k": k_i, "n_iter": int(res.n_iter),
                          "converged": bool(res.converged)})
        cell_histories.append(list(res.history))
        del res, cell_docs

    # 4. The nested artifact.  The flat surface runs only exact classifies,
    # which read no thresholds: trivial params.
    index = build_mean_index(means_t, StructuralParams.trivial(dim))
    model = TwoLevelFittedModel(
        index=index, coarse_index=coarse_index,
        cell_sizes=fine_k.astype(np.int32), n_probe=config.n_probe,
        cell_meta=cell_meta, labels=labels, rho_self=rho, history=history,
        converged=all_converged, n_iter=n_iter, algo=config.algo,
        strategy="two_level")
    state = KMeansState(
        index=index, assign=labels, rho_self=rho, rho_self_prev=rho,
        iteration=n_iter,
        ub=torch.zeros((n, n_ub_groups(k_eff)), dtype=torch.float32,
                       device=dev))
    return TwoLevelResult(model=model, state=state, assign=labels,
                          history=history, params=index.params,
                          converged=all_converged, n_iter=n_iter,
                          cell_histories=cell_histories)


def two_level_from_means(mean_docs: SparseDocs, coarse_k: int, *,
                         n_probe: int = 1, algo: str = "mivi", seed: int = 0,
                         max_iter: int = 10, batch_size: int = 4096,
                         device="cuda", seed_rows=None
                         ) -> TwoLevelFittedModel:
    """K given unit-norm sparse vectors as the fine means of a nested
    model, the means themselves coarse-clustered into K_c cells (a flat
    fit with trivial thresholds).

    The vectors become the fine level as they are, reordered cell after
    cell (stable within a cell); an empty coarse cell keeps its coarse
    mean, so K_eff = K + (empty cells).  ``seed_rows`` as in
    :func:`two_level_fit`.
    """
    dev = resolve_device(device)
    mean_docs = mean_docs.to(dev).validate()
    k, dim = mean_docs.n_docs, mean_docs.dim
    cfg = ClusterConfig(k=coarse_k, algo=algo, params=None, seed=seed,
                        max_iter=max_iter, batch_size=batch_size,
                        device=str(dev)).validate()
    res = _flat_fit(mean_docs, cfg, None, seed_rows)
    coarse_index = res.state.index
    labels = res.assign[:k].long()
    del res
    sizes = torch.bincount(labels, minlength=coarse_k).cpu().numpy()
    cell_sizes = np.maximum(sizes, 1).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(cell_sizes)[:-1]])
    # Vector i's column: its cell's start plus its rank within the cell.
    order = torch.argsort(labels, stable=True)
    col = torch.empty((k,), dtype=torch.long, device=dev)
    col[order] = (torch.arange(k, device=dev)
                  - torch.from_numpy(np.cumsum(sizes) - sizes).to(dev)[
                      labels[order]]
                  + torch.from_numpy(starts).to(dev)[labels[order]])
    means_t = torch.zeros((dim, int(cell_sizes.sum())), dtype=torch.float32,
                          device=dev)
    live = mean_docs.row_mask()
    means_t.index_put_((mean_docs.ids[live].long(),
                        col[:, None].expand_as(live)[live]),
                       mean_docs.vals[live], accumulate=True)
    for c in np.flatnonzero(sizes == 0):
        means_t[:, int(starts[c])] = coarse_index.means_t[:, int(c)]
    return TwoLevelFittedModel(
        index=build_mean_index(means_t, StructuralParams.trivial(dim)),
        coarse_index=coarse_index, cell_sizes=cell_sizes, n_probe=n_probe,
        algo=algo, strategy="two_level")
