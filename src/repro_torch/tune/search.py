"""Cost-model-pruned autotuner over the gathers' tile settings
(counterpart of ``repro.tune.search``).

For a corpus regime (shape + skew) the search, with ``repro``'s rules:

1. enumerates the settings gather.cu has (``candidate_space``: the tile
   of each gather and the grid order), deduplicated by the launches each
   candidate makes at the probe's shape; the default is candidates[0];
2. prunes on the roofline (:mod:`repro_torch.tune.cost`): an infeasible
   candidate's bound is infinite, a candidate whose bound is over
   ``PRUNE_SLACK`` × the default's is dropped, the rest are ranked by
   (bound, index) and at most ``budget.max_timed`` are timed; the default
   is always timed;
3. times the survivors on a probe and keeps the fastest by (measured,
   bound, index).

What is timed.  ``repro`` sums four kernels (its plan's geometry moves
all four).  Here a config changes two launches, the ones timed:
``sparse_sim`` and ``esicp_gather``, each with counts as the fits launch
them, each the best of ``budget.repeat`` runs between CUDA events after a
warm-up.  ``segment_update`` and ``rho_gather`` have no tile knob, so
timing them would add the same to every candidate.

The probe.  ``repro`` draws its probe means on the host, a float64
(D, K) matrix: 40 GB at the NYT widths.  Here the means are drawn on the
operands' device from a seeded ``torch.Generator``, float32 with the
corpus's density, straight into one (D, K) matrix a block of rows at a
time, and released before the search returns, so before the fit
allocates its own.  The esicp probe runs at ``repro``'s t_th =
int(0.8·D), v_th = 0.1.

The search is deterministic under a fixed seed and budget but for the
timings; tests pin ``measure`` to a pure function, and production caches
the first winner per signature.  On CPU operands there is nothing to
tune (the plain versions have no launch geometry): :func:`ensure_tuned`
returns None there, as ``repro``'s reference backend does.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import torch

from repro_torch.tune.cache import TUNED_CACHE, corpus_signature
from repro_torch.tune.config import TILES, TunedConfig, default_tuned
from repro_torch.tune.cost import (KernelShape, batch_work, feasible,
                                   lower_bound_seconds)

#: A candidate whose bound exceeds ``slack ×`` the default's has lost on
#: the model; no timing noise recovers a 2× deficit.
PRUNE_SLACK = 2.0


@dataclasses.dataclass(frozen=True)
class SearchBudget:
    """How much the tuner may time (enumeration and pruning are always
    exhaustive and cheap).  ``probe_rows`` defaults to the fits' batch
    (``batch_size`` 4096), the launch the winner will run; ``repro``'s
    512 suits its interpreter."""

    max_timed: int = 8      # candidates that get timed
    repeat: int = 2         # best of N timed runs per kernel
    probe_rows: int = 4096  # corpus rows the probe uses


@dataclasses.dataclass
class SearchStats:
    """What the search did.  ``candidates`` holds one entry per candidate
    (its config, bound, whether it was pruned, its time or None);
    ``probe_bytes`` the probe's allocation and ``peak_bytes`` the device's
    peak (``torch.cuda.max_memory_allocated``, since the caller's last
    reset) when the search ends; ``seconds`` its wall time."""

    n_candidates: int = 0
    n_pruned: int = 0
    n_timed: int = 0
    default_bound_s: float = 0.0
    best_bound_s: float = 0.0
    default_measured_s: float = 0.0
    best_measured_s: float = 0.0
    candidates: list = dataclasses.field(default_factory=list)
    probe_bytes: int = 0
    peak_bytes: int = 0
    seconds: float = 0.0

    @property
    def pruned_fraction(self) -> float:
        return self.n_pruned / self.n_candidates if self.n_candidates else 0.0

    def to_dict(self) -> dict:
        return {"n_candidates": self.n_candidates, "n_pruned": self.n_pruned,
                "n_timed": self.n_timed,
                "pruned_fraction": round(self.pruned_fraction, 4),
                "default_measured_s": round(self.default_measured_s, 6),
                "best_measured_s": round(self.best_measured_s, 6)}


def candidate_space(shape: KernelShape) -> list[TunedConfig]:
    """Every (sims tile, esicp tile, grid order) of gather.cu,
    deduplicated by the launches it makes at ``shape``; the default
    first."""
    incumbent = default_tuned()
    cands = [incumbent]
    key = lambda c: c.geometry_key(b=shape.b, p=shape.p, d=shape.d,
                                   k=shape.k)
    seen = {key(incumbent)}
    for order, s, e in itertools.product(
            (False, True), range(len(TILES["sims"])),
            range(len(TILES["esicp"]))):
        cfg = TunedConfig(sims_setting=s, esicp_setting=e,
                          slab_fastest=order, source="search")
        if key(cfg) not in seen:
            seen.add(key(cfg))
            cands.append(cfg)
    return cands


def _probe_means(ids: torch.Tensor, vals: torch.Tensor, *, dim: int, k: int,
                 seed: int) -> torch.Tensor:
    """(D, K) float32 probe means on the operands' device: uniform values
    at the corpus's density (``repro``'s rule), drawn block by block so
    no second (D, K) temporary exists."""
    from repro_torch.core.meanindex import row_chunks

    dev = ids.device
    b = ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    live_per_row = float((vals != 0).sum()) / max(b, 1)
    nnz_per_col = max(1.0, (b / max(k, 1)) * live_per_row)
    density = min(1.0, nnz_per_col / max(dim, 1))
    means_t = torch.empty((dim, k), dtype=torch.float32, device=dev)
    for s, e in row_chunks(dim, k):
        blk = means_t[s:e]
        blk.uniform_(generator=gen)
        keep = torch.rand(blk.shape, generator=gen, device=dev) < density
        blk.mul_(keep)
    return means_t


def _measure_config(cfg: TunedConfig, probe, *, repeat: int) -> float:
    """Summed seconds of ``sparse_sim`` and ``esicp_gather`` with counts
    under ``cfg``, each the best of ``repeat`` runs between CUDA events
    after a warm-up."""
    from repro_torch.kernels import ops

    ids, vals, means_t = probe
    dim = means_t.shape[0]
    t_th, v_th = int(0.8 * dim), 0.1
    calls = (
        lambda: ops.sparse_sim(ids, vals, means_t, with_counts=True,
                               tuned=cfg),
        lambda: ops.esicp_gather(ids, vals, means_t, t_th, v_th,
                                 with_counts=True, tuned=cfg),
    )
    total = 0.0
    for fn in calls:
        fn()
        best = float("inf")
        for _ in range(max(repeat, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        total += best
    return total


def search_tuned_config(ids, vals, *, dim: int, k: int,
                        budget: SearchBudget | int | None = None,
                        seed: int = 0, measure=None, hw=None,
                        prune_slack: float = PRUNE_SLACK,
                        ) -> tuple[TunedConfig, SearchStats]:
    """The gather settings that win at this corpus regime.

    ``ids``/``vals`` (N, P) are the corpus's tuples; the probe is their
    first ``budget.probe_rows`` rows.  ``measure`` (candidate -> seconds)
    defaults to timing the gathers on the probe, which needs CUDA
    operands; tests pass a pure function.  On the card the feasibility
    gate asks the library for each candidate's blocks per SM.
    """
    t0 = time.perf_counter()
    if budget is None:
        budget = SearchBudget()
    elif isinstance(budget, int):
        budget = dataclasses.replace(SearchBudget(), max_timed=budget)
    ids = torch.as_tensor(ids)
    vals = torch.as_tensor(vals)
    b = min(int(ids.shape[0]), budget.probe_rows)
    p_ids, p_vals = ids[:b].contiguous(), vals[:b].contiguous()
    shape = KernelShape(b=b, p=int(ids.shape[1]), d=dim, k=k)
    on_card = ids.device.type == "cuda"
    blocks_per_sm = None
    if on_card:
        from repro_torch.kernels.esicp_gather import library

        blocks_per_sm = library().gather_blocks_per_sm
    cands = candidate_space(shape)
    stats = SearchStats(n_candidates=len(cands))

    # --- the model: feasibility + roofline bounds -------------------------
    work = batch_work(p_ids, p_vals, dim)
    kw = {} if hw is None else {"hw": hw}
    bounds = [lower_bound_seconds(cfg, shape, work, **kw)
              if feasible(cfg, blocks_per_sm=blocks_per_sm)
              else float("inf") for cfg in cands]
    stats.default_bound_s = bounds[0]

    # Drop what loses to the incumbent on the model, rank the rest and
    # time the budgeted head; the incumbent is always timed.
    order = sorted(range(len(cands)), key=lambda i: (bounds[i], i))
    survivors = [i for i in order
                 if bounds[i] <= prune_slack * bounds[0]][:budget.max_timed]
    if 0 not in survivors:
        survivors = survivors[:max(budget.max_timed - 1, 1)] + [0]
    stats.best_bound_s = min(bounds[i] for i in survivors)
    stats.n_timed = len(survivors)
    stats.n_pruned = stats.n_candidates - stats.n_timed

    # --- timing: only the survivors ---------------------------------------
    probe = None
    if measure is None:
        if not on_card:
            raise ValueError("timing the gathers needs CUDA operands; pass "
                             "measure= to search on the CPU")
        probe = (p_ids, p_vals, _probe_means(p_ids, p_vals, dim=dim, k=k,
                                             seed=seed))
        stats.probe_bytes = probe[2].numel() * 4

        def measure(cfg):
            return _measure_config(cfg, probe, repeat=budget.repeat)

    measured = {i: float(measure(cands[i])) for i in survivors}
    if probe is not None:
        stats.peak_bytes = torch.cuda.max_memory_allocated(ids.device)
        del probe
    stats.default_measured_s = measured[0]
    stats.candidates = [{"config": c.to_dict(), "bound_s": bounds[i],
                         "pruned": i not in measured,
                         "measured_s": measured.get(i)}
                        for i, c in enumerate(cands)]
    win = min(survivors, key=lambda i: (measured[i], bounds[i], i))
    stats.best_measured_s = measured[win]
    winner = cands[win].replace(source="search" if win else "default")
    stats.seconds = time.perf_counter() - t0
    return winner, stats


def ensure_tuned(docs, *, k: int | None, mode: str = "cached",
                 budget: SearchBudget | int | None = None,
                 seed: int = 0) -> TunedConfig | None:
    """The tuned config of a corpus, through the process cache.

    mode 'cached': the cached winner for this corpus signature, or None
    (the caller launches the defaults).  mode 'search': on a miss, run the
    pruned search under ``budget`` and cache the winner; the cache counts
    the searches it ran (``TUNED_CACHE.searches``) and keeps the last
    one's stats (``TUNED_CACHE.last_search``).  None when ``k`` is None
    (nothing to tune against) and on CPU operands (nothing to tune)."""
    if mode not in ("cached", "search"):
        raise ValueError(f"tune mode must be 'cached' or 'search', "
                         f"got {mode!r}")
    if k is None or docs.ids.device.type != "cuda":
        return None
    sig = corpus_signature(docs.ids, docs.vals, dim=docs.dim, k=k)
    hit = TUNED_CACHE.get(sig)
    if hit is not None or mode == "cached":
        return hit
    winner, stats = search_tuned_config(docs.ids, docs.vals, dim=docs.dim,
                                        k=k, budget=budget, seed=seed)
    TUNED_CACHE.searches += 1
    TUNED_CACHE.last_search = stats
    return TUNED_CACHE.put(sig, winner)
