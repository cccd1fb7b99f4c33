#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--n-docs N] [--max-iter R] [--ivf-iter R]
                          [--seed S] [--lm-batch B] [--lm-seq S]

Needs one CUDA GPU of compute capability 9.0 (H100); exits non-zero
without one, or when the package is missing beside this script.  Phases,
each of which fails the run on any error:

1. device  — name, power limit and capability (must be 9.0);
2. build   — every CUDA source under src/repro_torch/csrc/, one nvcc each,
             in parallel, into build/kernels/;
3. kernels — each of the five main-path kernels of the ES-ICP fit against
             its plain PyTorch version on the card at the main path's
             shapes (B 4096, K 10,000, D 495,126, P from the corpus), with
             the tolerance stated beside it; times from CUDA events.
             esicp_gather (rho12, y, sims, counts), sparse_sim (sims,
             counts) and esicp_filter are held bit for bit, and the batch's
             means-row bytes moved to the SMs are printed beside the
             gathers' bounds.  rho_gather runs as the update calls it
             (each row's first nnz slots), bit for bit against the plain
             version (``repro``'s windowed summation order) on the live
             values and against a second run, with the bound of its live
             tuples beside the old all-slots one;
             after phase 8 also on the bounds-esicp fit's labels and means.
             segment_update runs from the term-major layout the corpus
             builds once (its build time and bytes printed), twice and held
             bitwise, and bit for bit against the CPU plain version at
             20,000 documents x K 1,000.  Last, the sLSTM scan
             (``slstm_scan``) against its plain version, bit for bit or
             within 1e-6, at xlstm-125m's prefill (B 2, S 4096, D 768) and
             decode step (B 4, S 1, from a cached state), at (3, 200, 100)
             (D not a multiple of 32), with gates × 10, at S 16,384 and at
             the edges of the kernel's ring of T-step tiles (S = T - 1, T,
             T + 1, 3T + 5; D not a multiple of its channel group; B·D
             below one group) and of its short-scan walk (the walk's last
             S, the tiles' first), each with two launches of S/2 with the
             state carried equal to one launch bit for bit; its time
             beside the plain loop's and the bound, its geometry (blocks,
             warps, T, shared memory a block), registers and spills from
             the compiler's report;
4. small   — small fits on the card and on the CPU (plain versions), all
             nine algorithm modes (ES-ICP to convergence, the other eight
             to ``--small-iter`` iterations), and a classify: identical
             assignments after every iteration and identical integer
             history (Mult, |Z|, changed, n_moving, t_th);
5. main    — ``repro_torch.cluster.fit`` (ES-ICP, k 10,000, EstParams at
             iterations 1–2) and ``classify_docs`` on a synthetic corpus at
             the NYT widths of ``src/repro_torch/configs/nyt1m.py``
             (``config()``: vocab 495,126, nt_mean
             225.76), n_docs cut from 1,285,944 to ``--n-docs``.  Launch
             counters are zeroed just before and read just after: every
             kernel of the path must have launched and no plain version may
             have run;
6. breakdown — one more iteration from the fitted state, timed phase by
             phase (assignment epoch, update step, EstParams), here and
             after each fit of phase 7;
6a. serving — the main fit's model behind a ``ClusterServer`` at the same
             widths, one CUDA graph per bucket (8 ... 256) captured when
             it loads (each capture's seconds printed); per bucket a replay
             against the eager classify and ``classify_docs``, bit for
             bit; bucket 64's replay against its eager launches; 8 client
             threads x 64 requests of 1-64 corpus rows (from ``--seed``),
             every answer equal to ``classify_docs``'s: requests/s,
             documents/s, p50 and p99 latency, occupancy, replays per
             bucket, one capture per bucket; ``ClusterEngine.refit`` on the
             resident corpus (seconds, peak; its ρ equal to rho_gather's
             and the plain version's on its assignments and means); a
             hot-swap to the refit model under traffic, each answer the
             old model's or the refit's in full, no bucket captured again.
             Counters zeroed before the traffic and read after the swap:
             sparse_sim ran by graph replays, segment_update and
             rho_gather ran, no plain version;
7. modes   — ``fit(..., algo="sketch")`` and ``fit(..., algo="bounds-esicp")``
             at the same widths from the same seed rows, cut to
             ``--mode-iter`` iterations, each with its counters zeroed just
             before and read just after: both must give the ES-ICP fit's
             assignment at every iteration, and a peak memory below three
             (D, K) matrices;
8. sketch kernels — sketch_sim, doc_sketch and the gather kernel's
             per-row-threshold (``ta``) and squared-rows variants against
             their plain versions, bit for bit, at B 4096, S 64, K 10,000,
             D 495,126 on one corpus batch (doc_sketch timed back to
             back and, as its device time, in a CUDA graph beside an
             empty kernel's launch), with the bounds-esicp fit's
             means, thresholds and ρ_self (v_ta = ρ_self / ||x||_1);
             sketch_sim also on the Region-3 tail sketch (doc tail at t_th
             against ``region3_sketch``), with its no-FMA floor printed
             beside the bound; the square variant also at t_th 0 (rows
             whose ids do not ascend), with its tail slots, distinct tail
             rows and means-row bytes moved printed.
8a. two-level — ``two_level_fit`` (k 10,000, coarse_k 100 = √K, esicp,
             coarse and cell fits cut to ``--ivf-iter`` iterations,
             default 4) at the same widths, counters zeroed just before
             the fit and read after the classifies: coarse and cell fit
             seconds (a cell iteration with and without EstParams), cells
             fitted, cmax, the peak (below 80 GB and the flat fit's); the
             routed
             classify at n_probe 1, 4 and K_c against the flat classify
             (seconds, recall@1, mean and max ``scored``; every winner's
             sim equal to the flat one, n_probe = K_c equal to the flat
             classify bit for bit); the routed_scan kernel against its
             plain version on one batch at n_probe 1 and 4, on that batch
             sorted by its best cell and at n_probe = K_c, and at n_probe
             1 on means_t moved off 16-byte alignment (one column a
             thread, the path of K not a multiple of 4), bit for bit,
             beside its bound and the sectors of means its blocks ask for
             (``scripts/routed_scan_probe.py`` times it against another
             revision's source);
             the model behind a ``ClusterServer`` (one CUDA graph per
             bucket, 8 clients, every answer ``classify_docs_routed``'s
             bit for bit); ``ClusterEngine.refit``'s refusal.

Then the out-of-core plane, the resident corpus moved off the card:

9. streaming — the corpus written to a disk ``DocStore`` (chunks of
             32,768 rows, in a temporary directory, free space checked
             first, deleted at the end) and reopened memmapped; first the
             two-level fit over it (a streaming coarse fit, ``SubsetStore``
             cells) equal to phase 8a's bit for bit (labels, ρ_self, cells,
             coarse and fine means); then
             ``streaming_fit`` (esicp, the main fit's seed rows), counters
             zeroed just before and read just after: the assignment after
             every iteration, ρ_self, the final means and every history
             field but ``elapsed_s`` equal phase 5's resident fit bit for
             bit; esicp_gather, esicp_filter, segment_update (with and
             without ``init``) and rho_gather launched, no plain version.
             Per-iteration seconds beside the resident's, the fit's own
             seconds by pass, the peak, the prefetch's unhidden waits, a
             bare copy pass over the store, a chunk's term-major layout
             build;
             segment_update's ``init`` variant against its plain version
             (bitwise against the CPU one at 20,000 documents x K 1,000);
             ``classify_docs`` over the store equal to the resident
             classify, ``transform_docs`` over a one-chunk store of the
             first 4,096 rows equal to the resident sims, ``cps_curve``,
             ``mean_value_skew`` and NMI(streaming, resident) = 1; one
             ``ClusterEngine.refit`` round over the store, counters zeroed
             just before, equal to phase 6a's resident refit bit for bit
             (assign, ρ, means), with sparse_sim, segment_update with and
             without ``init`` and rho_gather launched, no plain version;
10. minibatch — two passes of ``algo_mode="minibatch"`` over the store:
             the objective must not fall, the peak stay below four (D, K)
             matrices, and only sparse_sim, segment_update and rho_gather
             launch;
11. small store — phase 4's nine-mode card fits again through an
             in-memory store of 4 chunks (identical fits), a mid-epoch
             checkpoint resume (identical labels), and a model saved on
             the card and loaded back (identical predictions).  At the NYT
             widths a streaming checkpoint holds λ, the running means and
             the means (≈ 59 GB), so it runs here only;
11a. tune  — the corpus back on the card: every setting of both gathers a
             tuned fit can launch (sims with counts and without, esicp
             with counts; tiles 0-3 in both grid orders) on one batch, bit
             for bit against the plain version and timed; an ES-ICP fit
             with ``tune="search"`` from a cold cache (``--mode-iter``
             iterations): the search's candidates (bound, pruned or
             timed), winner, seconds and probe memory; the fit's history
             but elapsed_s and assignments equal to phase 5's first
             iterations, its ρ_self to the sketch fit's (phase 7, the same
             iteration), and its tensors' peak above those before it no
             higher than phase 5's fit's; the model (19.8 GB) saved to a
             temporary directory, the cache cleared, the model loaded
             (its winner back in the cache) and a ``tune="cached"`` fit of
             one iteration that runs no search.
11b. mesh  — the mesh runtime (``repro_torch.distributed.mesh_fit``):
             (a) a world of one (NCCL, in this process) at the NYT widths,
             esicp, ``--max-iter`` iterations from phase 5's seed rows, on a
             fresh corpus object (the earlier fits' term-major layout
             freed: the fit builds one per λ span of its rows),
             counters zeroed just before and read just after: every
             iteration's assignment, ρ_self, the means (per-column sums of
             their bit patterns), the history and ``make_assign_fn``'s
             classify equal phase 5's bit for bit, the peak at most phase
             5's + 1 GiB, esicp_gather, esicp_filter, segment_update (with
             and without ``init``), rho_gather and sparse_sim launched, no
             plain version; (b) two spawned ranks at (1, 2), gloo on CUDA
             tensors sharing the card (NCCL refuses two ranks on one
             device), the corpus read from a disk store: each rank equal
             to phase 5's fit bit for bit, its seconds per iteration and
             peak printed; (c) (2, 1) and (2, 2) at 20,000 documents, K
             1,000, 3 iterations: assignments equal a world of one's,
             means within 1e-6,
             the mesh classify equal to ``classify_docs`` bit for bit.  The
             spawned ranks load the kernels phase 2 built; each world has
             a time limit, and a failed rank fails the run.

Then, with the clustering phases' memory freed, the LM serving path
(gemma3-1b, ``src/repro_torch/configs/gemma3_1b.py``, the seven other
attention-family archs of ``configs/registry.py``, then the two SSM archs):

12. lm kernels — flash_attention against its plain version at gemma3's
             shapes (BH 8, S 4096, hd 256, window 512 and -1, unit-normal
             inputs), at the attention family's full-width shapes
             (``--lm-batch`` × 24 heads, S ``--lm-seq``, hd 64 full causal;
             × 40, hd 128 full; × 48, hd 128 at windows 4096 and 1024;
             zamba2's × 32, hd 80 full, padded to 128), at head dims the
             wrapper pads (12 and 96), at (3, 200, 136, 64)
             window 48 (rows with no live key), max abs err ≤ 2e-5, and
             at (2, 1024, 256) full causal with q, k scaled by 6 (scores
             ≈ 30) within 2e-5 of the plain version in float64; times
             from CUDA events beside the plain version,
             ``scaled_dot_product_attention`` and two bounds (split-TF32
             on the tensor cores, fp32 on the CUDA cores); each
             instantiation's registers, spills (none allowed), shared
             memory and blocks an SM;
13. lm small — each of the ten archs' smoke configs (granite's and
             mixtral's also with the int8 KV cache), parameters made on
             the CPU from ``--seed`` and carried to the card, float32
             compute on both: prefill logits within 1e-4 (a 5-position
             frontend prefix for musicgen and chameleon) and identical
             greedy tokens from ``ServeLoop.generate`` (B 2, prompt 8, 16
             new; prefill S 48 for the MoE and SSM configs, 37 for the
             others); on the card one flash_attention launch per attention
             layer or shared_attn invocation, one slstm_scan launch per
             sLSTM layer, and no plain version;
14. lm main — gemma3-1b at full width, seeded weights on the card, bf16
             compute: ``make_prefill_fn`` on ``--lm-batch`` × ``--lm-seq``
             tokens (default 2 × 4096) with exactly one kernel launch per
             layer (26) and no plain call, finite logits; the same prefill
             with the plain attention agrees within twice the bf16 path's
             own rounding error (bf16 vs float32 compute, kernel path),
             top-1 included, and in float32 compute within 1e-3
             (``F32_PARITY_TOL``), top-1 included;
             ``ServeLoop(max_len=64).generate`` on B 4, a
             32-token prompt and 32 new tokens; torch.profiler's device
             time by kernel group, and the device's idle share, for one
             prefill and for 7 decode steps;
15. lm families — granite-moe-3b-a800m, gemma-2b and musicgen-large at
             full width and depth, qwen2.5-32b, qwen1.5-32b and
             chameleon-34b at full width and 4 layers, mixtral-8x22b at
             full width and 2 layers (what one card holds), each built on
             the card, run and freed before the next: phase 14's prefill
             checks (256 and 1024 seeded frontend positions for musicgen
             and chameleon) and a greedy decode (B 4, 32 + 16 new tokens,
             32 for granite); for granite also the int8 KV cache (the
             share of its greedy tokens equal to the bf16 cache's) and
             torch.profiler's device time by group (flash_attention, the
             MoE's dispatch/combine, its expert products, other matmuls,
             casts and copies) with the idle share, for one prefill and
             for 7 decode steps;
16. lm ssm — zamba2-2.7b and xlstm-125m at full width and depth, seeded
             weights built on the card (zamba2's shared attention block
             one parameter set for its 9 invocations), bf16 compute, each
             freed before the next: the prefill on ``--lm-batch`` ×
             ``--lm-seq`` tokens with exactly 9 flash_attention launches
             (zamba2) or 2 slstm_scan launches (xlstm) and no plain call,
             finite logits; the same prefill with the plain attention and
             the plain sLSTM scan agrees as in phase 14 (twice the bf16
             path's own error; float32 compute within 1e-3), top-1
             included; ``ServeLoop`` greedy decode (B 4, 32 + 32 tokens,
             one slstm_scan launch per sLSTM layer a step);
             torch.profiler's device time by group (the
             chunked recurrence's products and elementwise passes,
             slstm_scan, flash_attention, other matmuls, casts and copies)
             with the idle share, for one prefill and for 7 decode steps;
             peak memory;
17. train — (a) the backward kernels alone: flash_attention_bwd through
             ``ops.flash_attention``'s autograd Function against float64
             and float32 autograd through the plain version at gemma3's
             (8, 4096, 256), window 512 and full causal, at (``--lm-batch``
             × 32, 4096, 80 → 128) and at (3, 200, 136, 64) window 48 (rows
             with no live key: dq exactly 0), each gradient's max abs error
             at most 2× the plain float32 one's and 1e-4 of its largest
             magnitude, two runs bit for bit; slstm_scan_bwd against the
             plain reverse loop bit for bit (or within 1e-6 of the largest
             gradient, named) at (2, 4096, 768) from the zero state, S 1,
             D 100, the walk's last S and an S no multiple of the tile
             from cached states, two runs bit for bit, and S/2 + S/2 with
             the adjoints carried equal to one launch, its two launches'
             device times from the profiler (the forward again, the
             adjoints) and the adjoint chains' floor (``scripts/slstm_floor.cu``); times from
             CUDA events beside the plain backward, sdpa's float32 backward
             (flash) and the bounds, registers, spills (none allowed) and
             shared memory; (b) every
             smoke config's loss and gradients in float32 on the card,
             kernels (two forward launches a layer with remat, one
             backward) against the plain versions, the loss within 1e-4 and
             every gradient leaf within F32_PARITY_TOL of its largest
             magnitude, and one ``make_train_step``; (c) gemma3-1b (26
             layers) and xlstm-125m at full width, ``--lm-batch`` ×
             ``--lm-seq``, bf16, 3 AdamW steps each through
             ``launch/train.py``'s ``main``: finite losses and gradient
             norms, only kernel launches (remat's count) and no plain call,
             s a step, tokens/s and peak memory; then one float32 loss and
             gradient of each (gemma3-1b cut to its first 6 layers, one
             global), kernels against plain as in (b).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# TF32 products per fp32 operation in flash_attention (split-TF32:
# lo·hi + hi·lo + hi·hi).
TF32_PASSES = 3

# The NYT widths, set by main() from src/repro_torch/configs/nyt1m.py.
NYT_VOCAB = NYT_NT_MEAN = NYT_K = None
BATCH = 4096
STREAM_CHUNK = 32_768

REPLACES = {
    "esicp_gather": "src/repro/kernels/esicp_gather.py:91",
    "esicp_filter": "src/repro/kernels/esicp_filter.py:38",
    "segment_update": "src/repro/kernels/segment_update.py:61",
    "rho_gather": "src/repro/kernels/rho_gather.py:66",
    "sparse_sim": "src/repro/kernels/sparse_sim.py:152",
    # TA has no Pallas kernel: repro's backend runs its TAAT scan there.
    "esicp_gather_ta": "src/repro/kernels/esicp_gather.py:91",
    "sparse_sim_square": "src/repro/kernels/sparse_sim.py:152",
    # doc_sketch feeds sketch_sim; repro computes it with segment_sum.
    "doc_sketch": "src/repro/kernels/sketch_sim.py:25",
    "sketch_sim": "src/repro/kernels/sketch_sim.py:25",
    "flash_attention": "src/repro/kernels/flash_attention.py:66",
    "segment_update_init": "src/repro/kernels/segment_update.py:61",
    # repro's routed scan is plain JAX (a lax.scan), no Pallas kernel.
    "routed_scan": "src/repro/cluster/classify.py:114",
    # repro's sLSTM is plain JAX (a lax.scan over time), no Pallas kernel.
    "slstm_scan": "src/repro/models/ssm.py:156",
    # repro has no backward kernel: JAX differentiates its jnp attention
    # (_attn_core) and the sLSTM's lax.scan; these are those gradients.
    "flash_attention_bwd": "src/repro/models/layers.py:120",
    "slstm_scan_bwd": "src/repro/models/ssm.py:156",
}
SOURCES = {
    "esicp_gather": "src/repro_torch/csrc/gather.cu",
    "esicp_filter": "src/repro_torch/csrc/esicp_filter.cu",
    "segment_update": "src/repro_torch/csrc/segment_update.cu",
    "rho_gather": "src/repro_torch/csrc/rho_gather.cu",
    "sparse_sim": "src/repro_torch/csrc/gather.cu",
    "esicp_gather_ta": "src/repro_torch/csrc/gather.cu",
    "sparse_sim_square": "src/repro_torch/csrc/gather.cu",
    "doc_sketch": "src/repro_torch/csrc/sketch.cu",
    "sketch_sim": "src/repro_torch/csrc/sketch.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "segment_update_init": "src/repro_torch/csrc/segment_update.cu",
    "routed_scan": "src/repro_torch/csrc/routed_scan.cu",
    "slstm_scan": "src/repro_torch/csrc/slstm_scan.cu",
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "slstm_scan_bwd": "src/repro_torch/csrc/slstm_scan_bwd.cu",
}
# The kernels each main-path run must launch.
PATH_KERNELS = {
    "esicp": ("esicp_gather", "esicp_filter", "segment_update", "rho_gather",
              "sparse_sim"),
    "sketch": ("sparse_sim", "doc_sketch", "sketch_sim", "segment_update",
               "rho_gather"),
    "bounds-esicp": ("esicp_gather", "esicp_filter", "doc_sketch",
                     "sketch_sim", "segment_update", "rho_gather"),
    "streaming": ("esicp_gather", "esicp_filter", "segment_update",
                  "segment_update_init", "rho_gather"),
    "minibatch": ("sparse_sim", "segment_update", "rho_gather"),
    # sparse_sim also by graph replays, counted by the servable
    "serving": ("sparse_sim", "segment_update", "rho_gather"),
    "store refit": ("sparse_sim", "segment_update", "segment_update_init",
                    "rho_gather"),
    # the two-level fit (coarse and cell esicp fits) and routed classify
    "two_level": ("esicp_gather", "esicp_filter", "segment_update",
                  "rho_gather", "sparse_sim", "routed_scan"),
    "two_level store": ("esicp_gather", "esicp_filter", "segment_update",
                        "segment_update_init", "rho_gather"),
    # the esicp fits with tune="search" and, after a load, "cached"
    "tune": ("esicp_gather", "esicp_filter", "segment_update", "rho_gather",
             "sparse_sim"),
    # the mesh fits (λ span by span: segment_update, then its init launch)
    # and the mesh classify
    "mesh": ("esicp_gather", "esicp_filter", "segment_update",
             "segment_update_init", "rho_gather", "sparse_sim"),
}
# The mesh phase: a spawned world's time limit, and the size of the
# (2, 1) and (2, 2) worlds.
MESH_WORLD_TIMEOUT = 600.0
MESH_SMALL_DOCS = 20_000
MESH_SMALL_K = 1_000
MESH_SMALL_ITER = 3
# The two-level phase: K_c = sqrt(K), the ratio of repro's IVF benchmark
# (BENCH_ivf.json: K 4096, K_c 64).
IVF_COARSE_K = 100
IVF_PROBES = (1, 4, IVF_COARSE_K)
INTS = ("mult", "n_candidates", "n_changed", "n_moving", "t_th")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds per call of ``fn`` from CUDA events, after one
    warm-up.  A rep runs enough calls back to back to last about 2 ms, so
    the host's cost of launching a short kernel does not count as device
    time."""
    def run(calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    fn()
    torch.cuda.synchronize()
    calls = max(1, min(50, int(2.0 / max(run(1), 1e-3))))
    return statistics.median(run(calls) for _ in range(reps))


def graph_ms(torch, fn, calls: int = 100, reps: int = 5) -> float:
    """Median device milliseconds per call of ``fn`` with ``calls`` calls
    captured in one CUDA graph and the graph replayed: no host work runs
    between the launches, so a kernel shorter than its launch path on the
    host reads its own time (plus the gap between two graph nodes)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def empty_launch_ms(torch) -> float:
    """Device time per launch of an empty kernel (``torch.cuda._sleep(0)``
    spins for no cycles), as :func:`graph_ms` times a kernel: what launch
    and retirement alone cost."""
    return graph_ms(torch, lambda: torch.cuda._sleep(0))


def peaks():
    """One H100 SXM's data-sheet peaks, the port's one copy of them
    (``repro_torch.roofline.analysis.HW``)."""
    from repro_torch.roofline.analysis import HW

    return HW()


def bound_ms(n_bytes: float, flops: float, rate: float | None = None):
    """(ms, "bytes" or "operations"): the larger of the bytes at the
    memory rate and the operations at ``rate`` (default fp32)."""
    from repro_torch.roofline.analysis import roofline_terms

    t = roofline_terms({"flops": flops, "bytes accessed": n_bytes}, peaks(),
                       rate=rate)
    t_bytes, t_ops = t["t_memory_s"] * 1e3, t["t_compute_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def requested_bytes(torch) -> tuple[int, int]:
    """(current, peak since the last reset) bytes the live tensors asked
    the caching allocator for, without its rounding of blocks."""
    stats = torch.cuda.memory_stats()
    return (stats["requested_bytes.all.current"],
            stats["requested_bytes.all.peak"])


def max_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def check_close(torch, name, got, want, tol):
    """rtol = atol = tol; returns the max abs error."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
            f"vs {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    ok = torch.allclose(got, want, rtol=tol, atol=tol)
    err = max_err(torch, got, want)
    require(ok, f"{name}: max abs err {err} above tolerance {tol}")
    return err


def extra_text(row) -> str:
    return "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}"
                   for k, v in row.get("extra", {}).items())


def check_equal(torch, name, got, want):
    require(torch.equal(got, want), f"{name}: differs from the plain version")
    return 0.0


def chunked_compare(torch, a, b, tol):
    """(allclose, max abs err, bitwise equal) of two (D, K) matrices,
    compared row chunk by row chunk (no full-size temporary)."""
    from repro_torch.core.meanindex import row_chunks

    ok, err, same = True, 0.0, True
    for s, e in row_chunks(*a.shape):
        x, y = a[s:e], b[s:e]
        ok = ok and torch.allclose(x, y, rtol=tol, atol=tol)
        err = max(err, max_err(torch, x, y))
        same = same and torch.equal(x, y)
    return ok, err, same


def device_phase(torch):
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"nvidia-smi: {smi_line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)}; capability {cap}; count "
        f"{torch.cuda.device_count()}")
    require(cap == (9, 0), f"needs compute capability 9.0, got {cap}")
    return smi_line


def build_phase():
    from repro_torch.kernels import _build

    t0 = phase("build")
    secs = _build.build()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: { {k: round(v, 1) for k, v in secs.items()} })")
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in
                 _build.library_path(name).with_suffix(".log")
                 .read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in lines:
            log(f"  {name}: {ln}")


def kernel_phase(torch, docs, seed: int):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core.estparams import estimate_params
    from repro_torch.core.meanindex import normalized_means
    from repro_torch.kernels import ops, ref

    t0 = phase("kernels")
    dev = docs.device
    n, p = docs.ids.shape
    d, k = docs.dim, NYT_K
    gen = torch.Generator(device=dev).manual_seed(seed)
    vals_all = torch.where(docs.row_mask(), docs.vals, 0.0)
    nnz_all = int(docs.nnz.sum())
    rows = {}

    # segment_update over the whole corpus (the update's shape), through
    # the term-major layout the documents build once and keep; every 97th
    # row is assigned K, which must contribute nothing.
    from repro_torch.sparse.matrix import SparseDocs, term_major

    assign = torch.randint(0, k, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    assign[::97] = k
    layout_ms = time_ms(torch, lambda: term_major(docs.ids, vals_all, d=d),
                        reps=3)
    layout = docs.by_term
    nnz_t = layout.rows.numel()
    layout_bytes = sum(t.numel() * t.element_size() for t in layout)
    log(f"  term_major layout: {nnz_t} postings, {layout_bytes} bytes "
        f"({layout_bytes / 2**30:.3f} GiB), built in {layout_ms:.3f} ms "
        f"(once per corpus)")
    lam = ops.segment_update(assign, docs, k=k)
    lam2 = ops.segment_update(assign, docs, k=k)
    _, _, same = chunked_compare(torch, lam, lam2, 0.0)
    require(same, "segment_update: two runs differ bitwise")
    del lam2
    ms = time_ms(torch, lambda: ops.segment_update(assign, docs, k=k))
    lam_p = ref.segment_update(assign, docs.ids, vals_all, k, d)
    ok, err, _ = chunked_compare(torch, lam, lam_p, 1e-4)
    require(ok, f"segment_update: max abs err {err} above 1e-4")
    del lam_p
    plain_ms = time_ms(torch, lambda: ref.segment_update(
        assign, docs.ids, vals_all, k, d), reps=3)
    sel = ((assign < k)[:, None] & (vals_all != 0))
    flat = (docs.ids.long() * k + assign.long()[:, None])[sel]
    fvals = vals_all[sel]
    lib_out = torch.zeros(d * k, dtype=torch.float32, device=dev)

    def library_call():
        lib_out.zero_()
        lib_out.index_add_(0, flat, fvals)

    lib_ms = time_ms(torch, library_call, reps=3)
    del lib_out, flat, fvals, sel
    live_rows = int(((assign < k)[:, None] & (vals_all != 0)).sum())
    rows["segment_update"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound=bound_ms(layout_bytes + n * 4 + d * k * 4, live_rows),
        extra=dict(layout_ms=layout_ms, layout_bytes=layout_bytes))

    # Bit for bit against the CPU plain version at a size the host holds:
    # 20,000 documents, K 1,000, assignments K and -1 among them.
    n_h, k_h = min(n, 20_000), 1_000
    h_assign = torch.randint(0, k_h, (n_h,), generator=gen, device=dev,
                             dtype=torch.int32)
    h_assign[::97] = k_h
    h_assign[1::89] = -1
    h_docs = SparseDocs(docs.ids[:n_h].contiguous(),
                        docs.vals[:n_h].contiguous(), docs.nnz[:n_h], d)
    got = ops.segment_update(h_assign, h_docs, k=k_h).cpu()
    want = ref.segment_update(h_assign.cpu(), h_docs.ids.cpu(),
                              h_docs.live_vals().cpu(), k_h, d)
    require(torch.equal(got, want), "segment_update: differs from the CPU "
            f"plain version at {n_h} documents, K {k_h}")
    log(f"  segment_update bitwise equal to the CPU plain version at "
        f"{n_h} documents x K {k_h} (D {d}); two full-width runs bitwise "
        f"equal")
    del got, want

    # Realistic means: the normalised cluster sums of that assignment.
    means_t = normalized_means(lam, lam)
    del lam

    # rho_gather over the whole corpus as the update calls it: each row's
    # first nnz slots (values past nnz may be anything); bit for bit
    # against the plain version on the live values with every slot read,
    # and on a second run (the kernel's centroid order within a bin is
    # free).
    full = torch.full_like(docs.nnz, p)
    rho = ops.rho_gather(assign, docs.ids, docs.vals, means_t, docs.nnz)
    check_equal(torch, "rho_gather", rho, ref.rho_gather(
        assign, docs.ids, vals_all, means_t, full))
    check_equal(torch, "rho_gather nnz", rho, ref.rho_gather(
        assign, docs.ids, docs.vals, means_t, docs.nnz))
    check_equal(torch, "rho_gather second run", rho, ops.rho_gather(
        assign, docs.ids, docs.vals, means_t, docs.nnz))
    check_equal(torch, "rho_gather every slot", rho, ops.rho_gather(
        assign, docs.ids, vals_all, means_t, full))
    require(bool((rho[::97] == 0).all()), "rho_gather: assign = K must read 0")
    # The least bytes: each live tuple of a row assigned in [0, K) (8 B)
    # and its means entry (4 B), assign and ρ of every row, nnz of those.
    in_k = (assign >= 0) & (assign < k)
    live_in = int((vals_all != 0)[in_k].sum())
    n_in = int(in_k.sum())
    rows["rho_gather"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.rho_gather(
            assign, docs.ids, docs.vals, means_t, docs.nnz)),
        plain_ms=time_ms(torch, lambda: ref.rho_gather(
            assign, docs.ids, docs.vals, means_t, docs.nnz), reps=3),
        library_ms=None,
        bound=bound_ms(live_in * 12 + n * 8 + n_in * 4, 2 * live_in),
        extra=dict(
            # The count held before the nnz operand: every slot's tuple.
            bound_all_slots_ms=bound_ms(n * p * 8 + n * 8 + nnz_all * 4,
                                        2 * nnz_all)[0],
            all_slots_ms=time_ms(torch, lambda: ops.rho_gather(
                assign, docs.ids, vals_all, means_t, full))))

    # Thresholds as EstParams picks them for these means.
    params, _ = estimate_params(docs, docs.df, means_t, rho, k=k)
    log(f"  thresholds for the checks: t_th {params.t_th} v_th {params.v_th}")

    b_ids = docs.ids[:BATCH].contiguous()
    b_vals = docs.vals[:BATCH].contiguous()
    live = b_vals != 0
    b_nnz = int(live.sum())
    uniq = int(torch.unique(b_ids[live]).numel())

    # esicp_gather on one assignment batch (with the Mult counts).
    got = ops.esicp_gather(b_ids, b_vals, means_t, params.t_th, params.v_th,
                           with_counts=True)
    want = ref.esicp_gather(b_ids, b_vals, means_t, params.t_th, params.v_th,
                            with_counts=True)
    for nm, g, w in zip(("rho12", "y", "sims", "counts"), got, want):
        check_equal(torch, f"esicp_gather.{nm}", g, w)
    log("  esicp_gather bitwise equal to plain")
    rows["esicp_gather"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.esicp_gather(
            b_ids, b_vals, means_t, params.t_th, params.v_th,
            with_counts=True)),
        plain_ms=time_ms(torch, lambda: ref.esicp_gather(
            b_ids, b_vals, means_t, params.t_th, params.v_th,
            with_counts=True), reps=3),
        library_ms=None,
        bound=bound_ms(uniq * k * 4 + BATCH * p * 8 + BATCH * k * 16,
                       2 * 4 * b_nnz * k))

    # esicp_filter on that batch's bound operands.
    rho12, y = got[0], got[1]
    moving = torch.rand((k,), generator=gen, device=dev) < 0.5
    xstate = torch.rand((BATCH,), generator=gen, device=dev) < 0.5
    col_ok = (moving[None, :] | ~xstate[:, None]).contiguous()
    rho_max = rho[:BATCH].contiguous()
    mask, count = ops.esicp_filter(rho12, y, rho_max, col_ok, params.v_th)
    mask_p, count_p = ref.esicp_filter(rho12, y, rho_max, col_ok, params.v_th)
    check_equal(torch, "esicp_filter.mask", mask, mask_p)
    check_equal(torch, "esicp_filter.count", count, count_p)
    log(f"  esicp_filter survivors per row: {float(count.float().mean()):.1f}"
        f" of {k}")
    rows["esicp_filter"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.esicp_filter(rho12, y, rho_max, col_ok,
                                                   params.v_th)),
        plain_ms=time_ms(torch, lambda: ref.esicp_filter(
            rho12, y, rho_max, col_ok, params.v_th)),
        library_ms=None,
        bound=bound_ms(BATCH * k * 10 + BATCH * 8, 3 * BATCH * k))
    del got, want, rho12, y, mask, mask_p, col_ok

    # sparse_sim as classify calls it (sims only), checked with counts too.
    got = ops.sparse_sim(b_ids, b_vals, means_t, with_counts=True)
    want = ref.sparse_sim(b_ids, b_vals, means_t, with_counts=True)
    check_equal(torch, "sparse_sim.sims", got[0], want[0])
    check_equal(torch, "sparse_sim.counts", got[1], want[1])
    log("  sparse_sim bitwise equal to plain")
    with warnings.catch_warnings():   # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                       live.sum(1).cumsum(0)]),
            b_ids[live].long(), b_vals[live], size=(BATCH, d),
            check_invariants=False)
    lib_sims = torch.sparse.mm(csr, means_t)
    check_close(torch, "torch.sparse.mm yardstick", lib_sims, got[0], 1e-4)
    del lib_sims
    rows["sparse_sim"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.sparse_sim(b_ids, b_vals, means_t)),
        plain_ms=time_ms(torch, lambda: ref.sparse_sim(b_ids, b_vals,
                                                       means_t), reps=3),
        library_ms=time_ms(torch, lambda: torch.sparse.mm(csr, means_t)),
        bound=bound_ms(uniq * k * 4 + BATCH * p * 8 + BATCH * k * 4,
                       2 * b_nnz * k))
    log(f"  batch of {BATCH}: {b_nnz} live tuples over {uniq} distinct rows")
    log_moved_bytes(torch, b_ids, live, d, k, rows)
    del got, want, csr, means_t
    torch.cuda.empty_cache()
    rows["slstm_scan"] = slstm_rows(torch, seed)
    for name, r in rows.items():
        log(f"  {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound"
            f" {r['bound'][0]:.3f} ms by {r['bound'][1]}, library "
            f"{r['library_ms']}{extra_text(r)}) max abs err "
            f"{r['max_abs_err']:.3g}")
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")
    return rows


# xlstm-125m's sLSTM shapes: (what, B, S, D, gate scale, initial state
# from a seeded cache (else the prefill's c = n = 0, m = -1e30)).
SLSTM_CASES = (("xlstm-125m prefill", 2, 4096, 768, 1.0, False),
               ("xlstm-125m decode step", 4, 1, 768, 1.0, True),
               ("D not a multiple of 32", 3, 200, 100, 1.0, True),
               ("gates x10", 2, 4096, 768, 10.0, False),
               ("S 16,384", 2, 16384, 768, 1.0, False))
SLSTM_TOL = 1e-6


def slstm_cases(tile: int, channels: int, walk: int) -> tuple:
    """SLSTM_CASES and the kernel's edges for its tile of ``tile`` steps,
    blocks of ``channels`` channels and its walk below ``walk`` steps: the
    last walk and the first tiles; S = T - 1, T, T + 1 and 3T + 5; D not a
    multiple of the group (D % 4 == 0: 16-byte copies of a partial group);
    B·D below one group, D % 4 != 0 (4-byte copies)."""
    t = tile
    return SLSTM_CASES + (
        ("S = W - 1, the walk's last", 4, walk - 1, 768, 1.0, True),
        ("S = W, the tiles' first", 4, walk, 768, 1.0, True),
        ("S = T - 1", 2, t - 1, 768, 1.0, False),
        ("S = T", 2, t, 768, 1.0, True),
        ("S = T + 1", 2, t + 1, 768, 1.0, True),
        ("S = 3T + 5", 2, 3 * t + 5, 768, 3.0, True),
        (f"D {channels + 4}, not a multiple of the group", 3, 3 * t + 5,
         channels + 4, 1.0, True),
        ("B·D 7, below one group", 1, t + 1, 7, 1.0, True))


def slstm_state(torch, b: int, d: int, gen, cached: bool):
    dev = torch.device("cuda")
    if not cached:
        zero = torch.zeros((b, d), device=dev)
        return zero, zero.clone(), torch.full((b, d), -1e30, device=dev)
    return (torch.randn((b, d), generator=gen, device=dev),
            torch.rand((b, d), generator=gen, device=dev) * 4 + 0.5,
            torch.randn((b, d), generator=gen, device=dev) * 3)


def slstm_compare(torch, what: str, got, want) -> tuple[float, bool]:
    """(max abs err, bitwise) of (hs, c, n, m) against the plain version;
    fails above SLSTM_TOL."""
    err, same = 0.0, True
    for name, g, w in zip(("hs", "c", "n", "m"), got, want):
        require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"slstm_scan {what}: {name} malformed")
        same = same and torch.equal(g, w)
        err = max(err, max_err(torch, g, w))
    require(err <= SLSTM_TOL, f"slstm_scan {what}: max abs err {err} above "
            f"{SLSTM_TOL}")
    return err, same


def slstm_rows(torch, seed: int) -> dict:
    """slstm_scan against its plain version at ``slstm_cases``, each with
    the split-state check, and its times beside the plain loop's and the
    bound."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import slstm_scan as kern

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    smem, per_sm = kern.resources()
    errs, bitwise, timed = [], True, {}
    for what, b, s, d, scale, cached in slstm_cases(kern.TILE, kern.CHANNELS,
                                                    kern.WALK_BELOW):
        gates = torch.randn((b, s, 4 * d), generator=gen, device=dev) * scale
        state = slstm_state(torch, b, d, gen, cached)
        ops.reset_counts()
        got = ops.slstm_scan(gates, *state)
        require(ops.LAUNCHES["slstm_scan"] == 1 and ops.PLAIN["slstm_scan"]
                == 0, f"slstm_scan {what} did not launch once")
        err, same = slstm_compare(torch, what, got,
                                  ref.slstm_scan(gates, *state))
        errs.append(err)
        bitwise = bitwise and same
        carried = ""
        if s > 1:
            half = s // 2
            first = ops.slstm_scan(gates[:, :half].contiguous(), *state)
            second = ops.slstm_scan(gates[:, half:].contiguous(), *first[1:])
            split = (torch.cat([first[0], second[0]], dim=1), *second[1:])
            require(all(torch.equal(a, w) for a, w in zip(split, got)),
                    f"slstm_scan {what}: S/2 + S/2 with the state carried "
                    f"differs from one launch over S")
            carried = "; S/2 + S/2 with the state carried equals one launch"
        log(f"  slstm_scan {what} (B {b}, S {s}, D {d}, gates x{scale:g}): "
            f"{'bit for bit' if same else f'max abs err {err:.3g}'} against "
            f"the plain version{carried}; {kern.blocks(b, d, s)} blocks "
            f"({'walk' if s < kern.WALK_BELOW else 'tiles'})")
        if what == "xlstm-125m prefill":
            timed["prefill"] = (gates, state, b, s, d)
        if what == "xlstm-125m decode step":
            timed["decode"] = (gates, state)
    gates, state, b, s, d = timed["prefill"]
    ms = time_ms(torch, lambda: ops.slstm_scan(gates, *state))
    # gates read once, hs written once, the state read and written once
    n_bytes = 4 * b * s * 4 * d + 4 * b * s * d + 6 * 4 * b * d
    # 19 float operations a channel a step (adds, max, exp, tanh, the
    # sigmoid's exp, add and quotient, products, the output's quotient)
    bound = bound_ms(n_bytes, 19 * b * s * d)
    report = _build.ptxas_report("slstm_scan")
    res = next(r for r in report if "slstm_scan_kernel" in r["kernel"])
    walk = next(r for r in report if "slstm_walk_kernel" in r["kernel"])
    step_gates, step_state = timed["decode"]
    step_ms = time_ms(torch, lambda: ops.slstm_scan(step_gates, *step_state))
    row = dict(max_abs_err=max(errs),
               ms=ms,
               plain_ms=time_ms(torch, lambda: ref.slstm_scan(gates, *state),
                                reps=3),
               library_ms=None, bound=bound,
               extra=dict(bitwise=bitwise, dependent_steps=s,
                          ns_per_step=ms * 1e6 / s, decode_step_ms=step_ms,
                          blocks=kern.blocks(b, d, s), warps=kern.WARPS,
                          tile=kern.TILE, smem_bytes=smem,
                          registers=res["registers"],
                          spill_bytes=res["spill_stores"] + res["spill_loads"],
                          walk_below=kern.WALK_BELOW,
                          walk_registers=walk["registers"],
                          walk_spill_bytes=walk["spill_stores"]
                          + walk["spill_loads"]))
    log(f"  slstm_scan (B {b}, S {s}, D {d}): {ms:.3f} ms, "
        f"{row['extra']['ns_per_step']:.1f} ns a step over {s} dependent "
        f"steps; plain loop {row['plain_ms']:.1f} ms; bound {bound[0]:.4f} ms"
        f" by {bound[1]}; decode step (B 4, S 1, the walk) {step_ms:.4f} "
        f"ms; {kern.blocks(b, d, s)} blocks of {kern.WARPS} warps (two chain "
        f"warps, {kern.WARPS - 2} workers) over {kern.CHANNELS} channels, "
        f"tiles of {kern.TILE} steps, {smem} B of shared memory a block, "
        f"{per_sm} block(s) an SM (from the grid and the occupancy query; "
        f"where they land is not read)")
    for r in (res, walk):
        log(f"  {r['kernel']}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, loads {r['spill_loads']} B (ptxas)")
    return row


def fitted_rho(torch, docs, model, row) -> None:
    """rho_gather on a fitted state (the bounds-esicp fit's labels and
    means), the inputs the update gives it: bit for bit against the plain
    version, its time kept in the row as ``fitted_ms``."""
    from repro_torch.kernels import ops, ref

    args = (model.labels, docs.ids, docs.vals, model.index.means_t,
            docs.nnz)
    got = ops.rho_gather(*args)
    check_equal(torch, "rho_gather (fitted)", got, ref.rho_gather(*args))
    row["extra"]["fitted_ms"] = time_ms(torch, lambda: ops.rho_gather(*args))
    log(f"  rho_gather on the bounds-esicp fit's state: "
        f"{row['extra']['fitted_ms']:.4f} ms, bitwise equal to plain")


def log_moved_bytes(torch, ids, live, d: int, k: int, rows) -> None:
    """Means-row bytes the gathers move to the SMs on this batch, beside
    their bound: one K-row per live tuple (a walk tuple by tuple), one per
    distinct row of each document tile (the tiled kernel), and one per
    distinct row of the batch (what the bound counts)."""
    from repro_torch.kernels.esicp_gather import ESICP, SIMS, library
    from repro_torch.tune.cost import tile_distinct

    row = k * 4
    walk = int(live.sum()) * row
    distinct = tile_distinct(ids, live, d, ids.shape[0]) * row
    for name, mode in (("sparse_sim", SIMS), ("esicp_gather", ESICP)):
        bt = library().gather_tile_docs(mode, 0)
        tiled = tile_distinct(ids, live, d, bt) * row
        r = rows[name]
        log(f"  {name}: means rows moved to the SMs {tiled / 1e9:.3f} GB "
            f"(tiles of {bt} documents; a tuple-by-tuple walk "
            f"{walk / 1e9:.3f} GB, each distinct row once {distinct / 1e9:.3f}"
            f" GB); at {r['ms']:.3f} ms that is {tiled / r['ms'] / 1e9:.3f} "
            f"TB/s; bound {r['bound'][0]:.3f} ms by {r['bound'][1]}")


def log_square_bytes(torch, ids, tail, d: int, k: int, n_tail: int,
                     tail_rows: int, ms: float) -> None:
    """The square variant's counts and the means-row bytes it moves: Σ over
    document tiles of their distinct tail rows, against one K-row per tail
    slot (a walk tuple by tuple) and one per distinct tail row."""
    from repro_torch.kernels.esicp_gather import SQUARE, library
    from repro_torch.tune.cost import tile_distinct

    row = k * 4
    bt = library().gather_tile_docs(SQUARE, 0)
    tiled = tile_distinct(ids, tail, d, bt)
    log(f"  square variant: {n_tail} tail slots over {tail_rows} distinct "
        f"rows; Σ over tiles of {bt} documents of their distinct tail rows "
        f"{tiled}; means rows moved to the SMs {tiled * row / 1e9:.3f} GB "
        f"(a tuple-by-tuple walk {n_tail * row / 1e9:.3f} GB, each distinct "
        f"row once {tail_rows * row / 1e9:.3f} GB); at {ms:.3f} ms that is "
        f"{tiled * row / ms / 1e9:.3f} TB/s")


def _same_fits(torch, a, b, what: str) -> None:
    """Identical iteration count, assignment after every iteration and
    history integers."""
    require(a.n_iter == b.n_iter,
            f"{what}: iterations {a.n_iter} vs {b.n_iter}")
    for r, (ha, hb, ta, tb) in enumerate(zip(a.history, b.history,
                                             a.trajectory, b.trajectory)):
        require(torch.equal(ta, tb),
                f"{what}: assignments differ at iteration {r + 1}")
        require(all(ha[f] == hb[f] for f in INTS)
                and ha["v_th"] == hb["v_th"],
                f"{what}: history differs at iteration {r + 1}: {ha} vs {hb}")


def small_phase(torch, seed: int, small_iter: int):
    """The same small fits (all nine modes) + classify on the card and on
    the CPU.  Returns the launches of the TA and CS fits on the card (the
    only fits that run the gather kernel's ta and square variants)."""
    from repro_torch.cluster import ClusterConfig, classify_docs, fit
    from repro_torch.core.assignment import ALGORITHMS
    from repro_torch.core.lloyd import lloyd_fit
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.kernels import ops

    t0 = phase("small cross-check (cuda vs cpu), nine modes")
    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=3000, vocab=4096,
                                            nt_mean=60, n_topics=16,
                                            seed=seed), device="cpu")
    k = 32
    rows = draw_seed_rows(docs.n_docs, k, seed=seed)
    variant_launches = {}
    fits, card_fits = {}, {}
    for algo in ["esicp"] + [a for a in ALGORITHMS if a != "esicp"]:
        runs = {}
        for dev in ("cuda", "cpu"):
            ops.reset_counts()
            runs[dev] = lloyd_fit(
                docs, k=k, algo=algo, batch_size=1024,
                max_iter=30 if algo == "esicp" else small_iter,
                seed_rows=rows, df=df, device=dev, keep_trajectory=True)
            if dev == "cuda":
                torch.cuda.synchronize()
                for name in ("esicp_gather_ta", "sparse_sim_square"):
                    if ops.LAUNCHES[name]:
                        variant_launches[name] = (ops.LAUNCHES[name], algo)
        a, b = runs["cuda"], runs["cpu"]
        _same_fits(torch, a, b, algo)
        fits[algo], card_fits[algo] = b, a
        if algo == "esicp":
            for r, (ha, hb) in enumerate(zip(a.history, b.history)):
                log(f"  esicp iter {r+1}: mult {ha['mult']} changed "
                    f"{ha['n_changed']} objective cuda {ha['objective']:.6f}"
                    f" cpu {hb['objective']:.6f}")
        else:
            log(f"  {algo}: identical over {a.n_iter} iterations; mult per "
                f"iteration {[h['mult'] for h in a.history]}")
    # Every mode gives MIVI's assignments (exact by contract).
    for algo, res in fits.items():
        for r, (x, y) in enumerate(zip(res.trajectory,
                                       fits["mivi"].trajectory)):
            require(torch.equal(x, y),
                    f"{algo} differs from mivi at iteration {r + 1}")
    b = fits["esicp"]
    model = fit(docs, ClusterConfig(k=k, max_iter=30, batch_size=1024),
                df=df, seed_rows=rows)
    ca, _ = classify_docs(model.index, docs)
    cb, _ = classify_docs(model.index, docs, device="cpu")
    require(torch.equal(ca.cpu(), cb), "classify differs between cuda and cpu")
    require(torch.equal(model.labels.cpu(), b.assign),
            "fit() labels differ from the cpu lloyd_fit")
    require(sorted(variant_launches) == ["esicp_gather_ta",
                                         "sparse_sim_square"],
            f"the ta/square variants did not launch: {variant_launches}")
    log(f"nine modes identical cuda vs cpu and equal to mivi; classify "
        f"identical ({time.perf_counter() - t0:.1f} s); variant launches "
        f"{variant_launches}")
    small = dict(docs=docs, df=df, rows=rows, fits=card_fits, model=model,
                 small_iter=small_iter)
    return variant_launches, small


def main_phase(torch, docs, df, max_iter: int):
    from repro_torch.cluster import ClusterConfig, classify_docs, fit
    from repro_torch.kernels import ops

    t0 = phase(f"main path: fit k={NYT_K} esicp + classify, "
               f"N={docs.n_docs} D={docs.dim} P={docs.pad_width}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    req_base = requested_bytes(torch)[0]
    ops.reset_counts()
    model = fit(docs, ClusterConfig(k=NYT_K, algo="esicp", max_iter=max_iter,
                                    batch_size=BATCH), df=df,
                keep_trajectory=True)
    torch.cuda.synchronize()
    fit_own = requested_bytes(torch)[1] - req_base
    fit_counts = dict(ops.LAUNCHES)
    t_cls = time.perf_counter()
    labels, sims = classify_docs(model.index, docs, batch_size=BATCH)
    torch.cuda.synchronize()
    cls_s = time.perf_counter() - t_cls
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    peak = torch.cuda.max_memory_allocated()

    for h in model.history:
        log("  " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                               for k, v in h.items()}))
    log(f"  seconds per iteration: "
        f"{[round(h['elapsed_s'], 3) for h in model.history]}")
    log(f"  classify: {cls_s:.3f} s for {docs.n_docs} docs")
    log(f"  peak device memory: {peak / 2**30:.2f} GiB, "
        f"{(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
        f"allocated before the fit (one (D, K) float32 matrix: "
        f"{docs.dim * NYT_K * 4 / 2**30:.2f} GiB)")
    log(f"  kernel launches: fit {fit_counts}, fit+classify {launches}")
    n_iter = len(model.history)
    log("  launches per iteration of the fit: "
        f"{ {k: round(v / n_iter, 2) for k, v in fit_counts.items()} }; "
        f"per classify: "
        f"{ {k: launches[k] - fit_counts[k] for k in launches} }")
    log(f"  plain-version calls: {plain}")
    require(all(launches[n] > 0 for n in PATH_KERNELS["esicp"]),
            f"a kernel never launched on the main path: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"a plain version ran on the main path: {plain}")
    require(len(model.history) >= 1, "the fit ran no iteration")
    require(labels.shape == (docs.n_docs,) and bool(torch.isfinite(sims).all()),
            "classify output malformed")
    require(bool(((labels >= 0) & (labels < NYT_K)).all()),
            "classify labels out of range")
    # After the last iteration every doc's own centroid is its best unless
    # the fit stopped early; classify must never score below ρ_self.
    require(bool((sims >= model.rho_self - 1e-5).all()),
            "classify scored a doc below its own-centroid similarity")
    log(f"main path done in {time.perf_counter() - t0:.1f} s")
    return launches, model, (labels, sims), peak, fit_own


def breakdown_phase(torch, docs, df, model, algo: str = "esicp",
                    est: bool = True):
    """Where one more iteration's time goes, phase by phase (host clock
    around work that ends in a synchronize), from the fitted state.  The
    bounds start unknown (+inf), so a bounds mode's epoch prunes no group
    (its time does not depend on that: the exact sims are computed in
    full either way)."""
    from repro_torch.core.backends import KernelBackend
    from repro_torch.core.estparams import estimate_params
    from repro_torch.core.lloyd import _epoch
    from repro_torch.core.update import (KMeansState, n_ub_groups,
                                         update_step)
    from repro_torch.sparse.matrix import term_major

    phase(f"breakdown of one more {algo} iteration")
    n = docs.n_docs
    state = KMeansState(
        index=model.index, assign=model.labels, rho_self=model.rho_self,
        rho_self_prev=model.rho_self, iteration=model.n_iter,
        ub=torch.full((n, n_ub_groups(NYT_K)), torch.inf, device=docs.device))
    bk = KernelBackend()
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t
        return res

    timed("term_major layout (once per corpus)", lambda: term_major(
        docs.ids, docs.live_vals(), d=docs.dim))
    assign, ub, _, _, _ = timed("assignment epoch", lambda: _epoch(
        algo, bk, docs, state, BATCH))
    new = timed("update step", lambda: update_step(
        docs, assign, state.assign, state, state.index.params, k=NYT_K,
        backend=bk, ub=ub))
    del state
    if est:
        timed("EstParams", lambda: estimate_params(
            docs, df, new.index.means_t, new.rho_self, k=NYT_K))
    for name, sec in out.items():
        log(f"  {name}: {sec:.3f} s")
    return out


SERVE_CLIENTS = 8
SERVE_REQUESTS = 64      # a client's requests, of 1 to 64 documents each


def _client_plan(n_docs: int, seed: int, n_requests: int):
    """Per client, ``n_requests`` arrays of corpus rows (1 to 64 each),
    drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[rng.integers(0, n_docs, int(rng.integers(1, 65)))
             for _ in range(n_requests)] for _ in range(SERVE_CLIENTS)]


def _drive_clients(srv, name, rows_h, plan, until=None):
    """One thread per client, each submitting its requests in turn and
    waiting for each answer (60 s at most).  With ``until`` (an Event) a
    client goes round its requests until the event is set, then once more.
    Returns (latencies s, wall s, [(rows, assign, sims)])."""
    import threading

    lat, answers, errors = [], [], []
    lock = threading.Lock()
    ids_h, vals_h, nnz_h = rows_h

    def requests(reqs):
        while until is not None and not until.is_set():
            yield from reqs
        yield from reqs

    def client(reqs):
        for rows in requests(reqs):
            t = time.perf_counter()
            try:
                a, s = srv.submit(name, (ids_h[rows], vals_h[rows],
                                         nnz_h[rows])).result(timeout=60)
            except Exception as e:            # reported, and fails the run
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                lat.append(time.perf_counter() - t)
                answers.append((rows, a, s))

    threads = [threading.Thread(target=client, args=(reqs,))
               for reqs in plan]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a client hung")
    require(not errors, f"serving traffic failed: {errors[:3]}")
    return lat, wall, answers


def _traffic_line(srv, name, answers, lat, wall, since=0) -> str:
    """The traffic's rates and latencies; batches counted after ``since``,
    occupancy over the server's life."""
    stats = srv.stats(name)
    n_req = len(answers)
    n_docs = sum(len(a[0]) for a in answers)
    occ = stats["occupancy"]
    mean_occ = (sum(v["batches"] * v["mean_occupancy"] for v in occ.values())
                / max(1, sum(v["batches"] for v in occ.values())))
    lat_ms = sorted(x * 1e3 for x in lat)
    return (f"{SERVE_CLIENTS} clients, {n_req} requests of 1-64 documents, "
            f"{n_docs} documents in {wall:.3f} s = {n_req / wall:.1f} "
            f"requests/s, {n_docs / wall:.1f} documents/s; latency p50 "
            f"{statistics.median(lat_ms):.3f} ms, p99 "
            f"{lat_ms[int(0.99 * (len(lat_ms) - 1))]:.3f} ms; "
            f"{stats['n_batches'] - since} batches; over the server's life "
            f"mean occupancy {mean_occ:.4f}, peak live batches "
            f"{stats['peak_live_batches']}, by bucket {occ}")


def serving_phase(torch, docs, model, cls, seed: int):
    """The main fit's model behind a ClusterServer at the NYT widths: per
    bucket a graph replay against the eager classify and classify_docs,
    concurrent traffic, a refit on the resident corpus, a hot-swap to the
    refit model under traffic.  Counters are zeroed before the traffic and
    read after the swap's traffic; the checks that launch kernels come
    after that.  Returns (launches with the replays under sparse_sim, the
    refit's assign, ρ and means on the host)."""
    import threading

    import numpy as np

    from repro_torch.cluster import classify_docs
    from repro_torch.cluster.classify import _classify_fused
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import ClusterEngine, ClusterServer

    t0 = phase(f"serving: ClusterServer over the main fit's model, "
               f"K={NYT_K} D={docs.dim} P={docs.pad_width}")
    rows_h = (docs.ids.cpu().numpy(), docs.vals.cpu().numpy(),
              docs.nnz.cpu().numpy())
    want = [(cls[0].cpu().numpy(), cls[1].cpu().numpy())]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    srv = ClusterServer(max_live_batches=4, batch_timeout_s=0.002,
                        n_post_workers=2)
    try:
        sv = srv.load("nyt", model, pad_width=docs.pad_width)
        torch.cuda.synchronize()
        buckets = sv.sorted_batch_sizes
        ones = dict.fromkeys(buckets, 1)
        log(f"  built and captured in {time.perf_counter() - t:.3f} s; "
            f"capture s by bucket "
            f"{ {b: round(v, 4) for b, v in sv.capture_s.items()} }; graph "
            f"pools and staging "
            f"{(torch.cuda.memory_allocated() - base) / 2**20:.1f} MiB")
        require(sv.capture_counts() == ones, f"captures {sv.capture_counts()}")

        # Bit for bit per bucket: replay, eager, classify_docs.
        rng = np.random.default_rng(seed)
        for b in buckets:
            n = max(1, b - b // 8)            # dead padding rows too
            rows = rng.integers(0, docs.n_docs, n)
            batch = sv.pre_process([tuple(x[rows] for x in rows_h)])
            a, s = sv.post_process(sv.device_compute(batch), n)
            e_a, e_s = _classify_fused(torch.from_numpy(batch.ids).cuda(),
                                       torch.from_numpy(batch.vals).cuda(),
                                       sv.index.means_t)
            require(np.array_equal(a, e_a[:n].cpu().numpy())
                    and np.array_equal(s, e_s[:n].cpu().numpy()),
                    f"serving bucket {b}: replay differs from eager")
            require(np.array_equal(a, want[0][0][rows])
                    and np.array_equal(s, want[0][1][rows]),
                    f"serving bucket {b}: differs from classify_docs")
        log(f"  every bucket {list(buckets)}: graph replay equals the eager "
            f"classify and classify_docs bit for bit")

        # Bucket 64: its replay against the eager launches of the batch.
        batch64 = sv.pre_process([tuple(x[:64] for x in rows_h)])
        ids64 = torch.from_numpy(batch64.ids).cuda()
        vals64 = torch.from_numpy(batch64.vals).cuda()
        g = sv._graphs[64]
        g.ids.copy_(ids64)
        g.vals.copy_(vals64)
        replay_ms = time_ms(torch, g.graph.replay)
        eager_ms = time_ms(torch, lambda: _classify_fused(
            ids64, vals64, sv.index.means_t))

        def round_trip_ms(fn):
            times = []
            for _ in range(30):
                t = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t)
            return statistics.median(times) * 1e3

        rt_graph = round_trip_ms(lambda: sv.post_process(
            sv.device_compute(batch64), 64))
        rt_eager = round_trip_ms(lambda: [x.cpu() for x in _classify_fused(
            torch.from_numpy(batch64.ids).cuda(),
            torch.from_numpy(batch64.vals).cuda(), sv.index.means_t)])
        log(f"  bucket 64 back to back (CUDA events): graph replay "
            f"{replay_ms:.4f} ms, eager launches {eager_ms:.4f} ms; a "
            f"batch's host round trip (copy in, classify, copy out, wait), "
            f"median of 30: graph {rt_graph:.4f} ms, eager {rt_eager:.4f} ms")

        # The counted path: traffic, refit, swap under traffic.
        plan = _client_plan(docs.n_docs, seed, SERVE_REQUESTS)
        swap_plan = _client_plan(docs.n_docs, seed + 1, SERVE_REQUESTS // 4)
        torch.cuda.synchronize()
        ops.reset_counts()
        sv.reset_replay_counts()
        lat, wall, answers = _drive_clients(srv, "nyt", rows_h, plan)
        replays = sv.replay_counts()
        log(f"  traffic: {_traffic_line(srv, 'nyt', answers, lat, wall)}")
        log(f"  replays by bucket {replays}; captures {sv.capture_counts()};"
            f" kernels.ops launches during the traffic "
            f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }")
        require(not any(ops.LAUNCHES.values()),
                f"an eager launch during the traffic: {ops.LAUNCHES}")
        require(sum(replays.values()) == srv.stats("nyt")["n_batches"],
                f"replays {replays} against the batches")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = ClusterEngine.from_model(model, batch_size=BATCH)
        t = time.perf_counter()
        r_assign, r_rho = engine.refit(docs, n_iter=1)
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t
        refit_peak = torch.cuda.max_memory_allocated()
        new_model = engine.to_model()
        del engine

        swapped, done = {}, threading.Event()

        def do_swap():
            try:
                time.sleep(0.05)
                t = time.perf_counter()
                swapped["old"] = srv.swap("nyt", new_model)
                swapped["s"] = time.perf_counter() - t
            finally:
                done.set()

        since = srv.stats("nyt")["n_batches"]
        swapper = threading.Thread(target=do_swap)
        swapper.start()
        lat2, wall2, answers2 = _drive_clients(srv, "nyt", rows_h, swap_plan,
                                               until=done)
        swapper.join(600)
        require(not swapper.is_alive() and swapped.get("old") is sv,
                "the swap did not complete")
        new_sv = srv.registry.get("nyt")
        torch.cuda.synchronize()
        launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
        old_r, new_r = sv.replay_counts(), new_sv.replay_counts()
        replays_all = {b: old_r[b] + new_r[b] for b in buckets}
        peak = torch.cuda.max_memory_allocated()
        log(f"  refit (1 round, resident corpus): {refit_s:.3f} s, peak "
            f"{refit_peak / 2**30:.2f} GiB; "
            f"{int((r_assign != model.labels).sum())} documents left the "
            f"main fit's labels")
        log(f"  hot-swap under traffic: swap (build, capture, publish) "
            f"{swapped['s']:.3f} s; traffic "
            f"{_traffic_line(srv, 'nyt', answers2, lat2, wall2, since)}")
        log(f"  the old servable replayed "
            f"{sum(old_r.values()) - sum(replays.values())} of those "
            f"batches, the new {sum(new_r.values())}; new capture s by "
            f"bucket { {b: round(v, 4) for b, v in new_sv.capture_s.items()} }"
            f"; peak device memory since the refit began "
            f"{peak / 2**30:.2f} GiB")
        log(f"  counters over traffic, refit and swap: replays by bucket "
            f"{replays_all}; kernels.ops launches "
            f"{ {k: v for k, v in launches.items() if v} }; plain-version "
            f"calls { {k: v for k, v in plain.items() if v} }")
        require(sum(old_r.values()) > sum(replays.values())
                and sum(new_r.values()) > 0,
                "the swap's traffic did not run on both servables")
        require(all(launches[k] > 0 for k in PATH_KERNELS["serving"]),
                f"serving: a kernel of its path never launched: {launches}")
        require(all(v == 0 for v in plain.values()),
                f"serving: a plain version ran: {plain}")
        require(sv.capture_counts() == ones
                and new_sv.capture_counts() == ones,
                f"a bucket was captured again: {sv.capture_counts()}, "
                f"{new_sv.capture_counts()}")
        require(srv.stats("nyt")["n_failures"] == 0, "a request failed")

        # The checks, after the counters.
        for rows, a, s in answers:
            require(np.array_equal(a, want[0][0][rows])
                    and np.array_equal(s, want[0][1][rows]),
                    "a served answer differs from classify_docs")
        means_t = new_model.index.means_t
        check_equal(torch, "refit ρ vs rho_gather", r_rho, ops.rho_gather(
            r_assign, docs.ids, docs.vals, means_t, docs.nnz))
        check_equal(torch, "refit ρ vs plain", r_rho, ref.rho_gather(
            r_assign, docs.ids, docs.vals, means_t, docs.nnz))
        want.append(tuple(x.cpu().numpy() for x in classify_docs(
            new_model.index, docs, batch_size=BATCH)))
        n_old = 0
        for rows, a, s in answers2:
            old, new = ((np.array_equal(a, wa[rows])
                         and np.array_equal(s, ws[rows])) for wa, ws in want)
            require(old or new, "a torn answer under the swap")
            n_old += old and not new
        a, _ = srv.classify("nyt", tuple(x[:300] for x in rows_h),
                            timeout=60)
        require(np.array_equal(a, want[1][0][:300]),
                "after the swap the server does not answer with the refit")
        log(f"  {len(answers)} answers equal classify_docs bit for bit; "
            f"under the swap {len(answers2)} answers, each the old model's "
            f"({n_old} only the old's) or the refit's in full; the refit's "
            f"ρ equals rho_gather's and the plain version's on its "
            f"assignments and means bit for bit")
        t = time.perf_counter()
        refit_rec = dict(assign=r_assign.cpu(), rho=r_rho.cpu(),
                         means=means_t.cpu())
        log(f"  refit kept on the host for the streaming phase "
            f"({time.perf_counter() - t:.1f} s)")
    finally:
        srv.close()
    del new_model, new_sv, sv, means_t
    torch.cuda.empty_cache()
    log(f"serving phase done in {time.perf_counter() - t0:.1f} s")
    launches["sparse_sim"] += sum(replays_all.values())
    return launches, refit_rec


def mode_phase(torch, docs, df, algo: str, max_iter: int, esicp_traj):
    """fit(..., algo) at the NYT widths from the ES-ICP fit's seed rows:
    the same assignment at every iteration, its path's kernels launched,
    no plain version run, no third (D, K) matrix."""
    from repro_torch.cluster import ClusterConfig, fit
    from repro_torch.kernels import ops

    t0 = phase(f"main path: fit k={NYT_K} {algo}, max_iter {max_iter}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    model = fit(docs, ClusterConfig(k=NYT_K, algo=algo, max_iter=max_iter,
                                    batch_size=BATCH), df=df,
                keep_trajectory=True)
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    peak = torch.cuda.max_memory_allocated()
    matrix = docs.dim * NYT_K * 4
    for h in model.history:
        log("  " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                               for k, v in h.items()}))
    log(f"  seconds per iteration: "
        f"{[round(h['elapsed_s'], 3) for h in model.history]}")
    log(f"  Mult per iteration: {[h['mult'] for h in model.history]}")
    log(f"  |Z| per iteration: {[h['n_candidates'] for h in model.history]}")
    log(f"  peak device memory: {peak / 2**30:.2f} GiB "
        f"({peak / matrix:.3f} (D, K) matrices of {matrix / 2**30:.2f} GiB)")
    n_iter = len(model.history)
    log(f"  kernel launches: {launches}; per iteration "
        f"{ {k: round(v / n_iter, 2) for k, v in launches.items() if v} }")
    log(f"  plain-version calls: {plain}")
    require(all(launches[n] > 0 for n in PATH_KERNELS[algo]),
            f"{algo}: a kernel of its path never launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"{algo}: a plain version ran on the main path: {plain}")
    require(peak < 3 * matrix, f"{algo}: peak {peak} bytes holds a third "
            f"(D, K) matrix")
    want = esicp_traj[:max_iter]
    require(n_iter == len(want), f"{algo}: {n_iter} iterations, the esicp "
            f"fit's first {max_iter} took {len(want)}")
    for r, (a, b) in enumerate(zip(model.trajectory, want)):
        require(torch.equal(a, b), f"{algo}: assignment differs from the "
                f"esicp fit at iteration {r + 1}")
    log(f"  assignments equal the esicp fit's at all {n_iter} iterations")
    log(f"{algo} fit done in {time.perf_counter() - t0:.1f} s")
    return launches, model


def _cfg_text(cfg: dict) -> str:
    from repro_torch.tune.config import TILES

    tile = lambda g: "x".join(map(str, TILES[g][cfg[f"{g}_setting"]]))
    return (f"sims {cfg['sims_setting']} ({tile('sims')}), esicp "
            f"{cfg['esicp_setting']} ({tile('esicp')}), "
            f"{'slabs' if cfg['slab_fastest'] else 'tiles'} fastest")


def tune_phase(torch, docs, df, mode_iter: int, esicp_hist, esicp_traj,
               ref_rho, flat_own: int, seed: int):
    """The autotuner at the NYT widths.  (1) Every setting a tuned fit can
    launch (sims with counts and without, esicp with counts; tiles 0-3,
    each in both grid orders) on one batch, bit for bit against the plain
    version, and timed.  (2) An esicp fit with tune="search" from a cold
    cache, cut to ``mode_iter`` iterations: its search (candidates,
    bounds, timings, winner, seconds, the probe's memory), and the fit
    equal to the untuned one (history but elapsed_s and assignments
    against the main fit's first iterations, ρ_self against the untuned
    sketch fit's at the same iteration, whose assignments equal them),
    its peak above what was allocated before it no higher than the
    untuned fit's (``flat_own``: :func:`requested_bytes`, the tensors'
    own bytes, since the allocator may hand a block up to 1 MiB larger
    than asked).  (3) The model saved, the
    cache cleared, the model loaded (its winner back in the cache) and a
    tune="cached" fit that runs no search.  Returns (launches, per-setting
    ms)."""
    from repro_torch.cluster import ClusterConfig, fit, load_model
    from repro_torch.core.meanindex import normalized_means
    from repro_torch.kernels import ops, ref
    from repro_torch.tune import TUNED_CACHE, TunedConfig
    from repro_torch.tune.config import TILES

    t0 = phase(f"tune: the gathers' settings searched at k={NYT_K}, "
               f"cached, saved and loaded")
    dev = docs.device
    d, k = docs.dim, NYT_K
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    assign = torch.randint(0, k, (docs.n_docs,), generator=gen, device=dev,
                           dtype=torch.int32)
    lam = ops.segment_update(assign, docs, k=k)
    means_t = normalized_means(lam, lam)
    del assign, lam
    ids = docs.ids[:BATCH].contiguous()
    vals = docs.vals[:BATCH].contiguous()
    t_th, v_th = int(0.8 * d), 0.1
    want_s = ref.sparse_sim(ids, vals, means_t, with_counts=True)
    want_e = ref.esicp_gather(ids, vals, means_t, t_th, v_th,
                              with_counts=True)
    settings_ms = {"sparse_sim": {}, "esicp_gather": {}}
    for s in range(8):
        cfg = TunedConfig(sims_setting=s % 4, esicp_setting=s % 4,
                          slab_fastest=s >= 4)
        got = ops.sparse_sim(ids, vals, means_t, with_counts=True,
                             tuned=cfg)
        check_equal(torch, f"sparse_sim setting {s} sims", got[0], want_s[0])
        check_equal(torch, f"sparse_sim setting {s} counts", got[1],
                    want_s[1])
        check_equal(torch, f"sparse_sim setting {s} without counts",
                    ops.sparse_sim(ids, vals, means_t, tuned=cfg)[0],
                    want_s[0])
        got = ops.esicp_gather(ids, vals, means_t, t_th, v_th,
                               with_counts=True, tuned=cfg)
        for nm, g, w in zip(("rho12", "y", "sims", "counts"), got, want_e):
            check_equal(torch, f"esicp_gather setting {s} {nm}", g, w)
        del got
        ms_s = time_ms(torch, lambda: ops.sparse_sim(
            ids, vals, means_t, with_counts=True, tuned=cfg))
        ms_e = time_ms(torch, lambda: ops.esicp_gather(
            ids, vals, means_t, t_th, v_th, with_counts=True, tuned=cfg))
        settings_ms["sparse_sim"][s] = ms_s
        settings_ms["esicp_gather"][s] = ms_e
        log(f"  setting {s} ({'slabs' if s >= 4 else 'tiles'} fastest): "
            f"sparse_sim {'x'.join(map(str, TILES['sims'][s % 4]))} "
            f"{ms_s:.4f} ms, esicp_gather "
            f"{'x'.join(map(str, TILES['esicp'][s % 4]))} {ms_e:.4f} ms "
            f"(with counts); bitwise equal to plain")
    del means_t, want_s, want_e
    torch.cuda.empty_cache()
    log(f"  every setting of both gathers bitwise equal to plain on a "
        f"batch of {BATCH} (t_th {t_th}, v_th {v_th})")

    # The searched fit, from a cold cache.
    TUNED_CACHE.clear()
    cfg = ClusterConfig(k=k, algo="esicp", max_iter=mode_iter,
                        batch_size=BATCH, tune="search")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    req_base = requested_bytes(torch)[0]
    ops.reset_counts()
    t = time.perf_counter()
    model = fit(docs, cfg, df=df, keep_trajectory=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    own = requested_bytes(torch)[1] - req_base
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    stats = TUNED_CACHE.last_search
    require(TUNED_CACHE.searches == 1 and stats is not None,
            f"the searched fit ran {TUNED_CACHE.searches} searches")
    require(model.cuda_tuned is not None, "the searched fit carries no "
            "winner")
    winner = TunedConfig.from_dict(model.cuda_tuned)
    log(f"  search: {stats.n_candidates} candidates, {stats.n_pruned} "
        f"pruned, {stats.n_timed} timed, in {stats.seconds:.3f} s; probe "
        f"means {stats.probe_bytes / 2**30:.2f} GiB, device peak at the "
        f"search's end {stats.peak_bytes / 2**30:.2f} GiB")
    for c in stats.candidates:
        timed = ("pruned" if c["pruned"] else
                 f"timed {c['measured_s'] * 1e3:.4f} ms")
        log(f"    {_cfg_text(c['config'])}: bound "
            f"{c['bound_s'] * 1e3:.4f} ms, {timed}")
    log(f"  winner: {_cfg_text(winner.to_dict())} ({winner.source}), "
        f"{stats.best_measured_s * 1e3:.4f} ms against the default's "
        f"{stats.default_measured_s * 1e3:.4f} ms; signature "
        f"{winner.signature}")
    require(stats.best_measured_s <= stats.default_measured_s,
            "the winner is slower than the default")
    require(all(v == 0 for v in plain.values()),
            f"a plain version ran in the tuned fit: {plain}")
    require(all(launches[n] > 0 for n in PATH_KERNELS["tune"]),
            f"a kernel of the tuned fit never launched: {launches}")
    require(model.n_iter == min(mode_iter, len(esicp_hist)),
            f"the tuned fit ran {model.n_iter} iterations")
    for r, (h, want) in enumerate(zip(model.history, esicp_hist)):
        same = {f: v for f, v in h.items() if f != "elapsed_s"} == \
            {f: v for f, v in want.items() if f != "elapsed_s"}
        require(same, f"tuned fit: history differs at iteration {r + 1}: "
                f"{h} vs {want}")
        require(torch.equal(model.trajectory[r], esicp_traj[r]),
                f"tuned fit: assignments differ at iteration {r + 1}")
    require(torch.equal(model.rho_self.cpu(), ref_rho),
            "tuned fit: ρ_self differs from the untuned fit's")
    require(own <= flat_own, f"tuned fit: tensors of {own} bytes at its "
            f"peak above those before it, the untuned fit's {flat_own}")
    log(f"  tuned fit equals the untuned one over {model.n_iter} "
        f"iterations (history but elapsed_s, assignments, ρ_self); peak "
        f"{peak / 2**30:.2f} GiB allocated ({base / 2**30:.2f} GiB before "
        f"it); its tensors' peak above those before it {own} bytes, the "
        f"untuned fit's {flat_own} ({(own - flat_own) / 2**20:+.3f} MiB); "
        f"wall {wall:.3f} s")
    log(f"  s per iteration, tuned: "
        f"{[round(h['elapsed_s'], 3) for h in model.history]}; untuned: "
        f"{[round(h['elapsed_s'], 3) for h in esicp_hist[:model.n_iter]]}")

    # Saved, the cache cleared, loaded: the winner comes back with it.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tuned_") as md:
        t = time.perf_counter()
        model.save(md)
        save_s = time.perf_counter() - t
        del model
        torch.cuda.empty_cache()
        TUNED_CACHE.clear()
        t = time.perf_counter()
        back = load_model(md, device="cuda")
        load_s = time.perf_counter() - t
    require(back.cuda_tuned == winner.to_dict() and TUNED_CACHE.get(
        winner.signature) == winner, "the loaded model did not bring its "
        "winner back into the cache")
    del back
    torch.cuda.empty_cache()
    ops.reset_counts()
    cached = fit(docs, cfg.replace(tune="cached", max_iter=1), df=df,
                 keep_trajectory=True)
    torch.cuda.synchronize()
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    require(TUNED_CACHE.searches == 0, f"the cached fit ran "
            f"{TUNED_CACHE.searches} searches")
    require(cached.cuda_tuned == winner.to_dict(), "the cached fit ran "
            "without the loaded winner")
    require({f: v for f, v in cached.history[0].items() if f != "elapsed_s"}
            == {f: v for f, v in esicp_hist[0].items() if f != "elapsed_s"}
            and torch.equal(cached.trajectory[0], esicp_traj[0]),
            "the cached fit differs from the untuned fit")
    log(f"  saved in {save_s:.1f} s, cache cleared, loaded in {load_s:.1f} "
        f"s; the tune=\"cached\" fit ran 0 searches with the loaded winner,"
        f" its iteration equal to the untuned fit's")
    del cached
    torch.cuda.empty_cache()
    log(f"tune phase done in {time.perf_counter() - t0:.1f} s")
    return launches, settings_ms


def sketch_kernel_phase(torch, docs, model):
    """The sketch kernels and the two gather variants against their plain
    versions at the main path's shapes, with a fitted model's means,
    thresholds and ρ_self."""
    from repro_torch.core.meanindex import region3_sketch, sketch_size
    from repro_torch.kernels import ops, ref

    t0 = phase("sketch kernels and gather variants")
    index = model.index
    means_t, params = index.means_t, index.params
    d, k = docs.dim, NYT_K
    s_dim = sketch_size(d)
    b_ids = docs.ids[:BATCH].contiguous()
    b_vals = docs.vals[:BATCH].contiguous()
    _, p = b_ids.shape
    live = b_vals != 0
    b_nnz = int(live.sum())
    uniq = int(torch.unique(b_ids[live]).numel())
    rows = {}
    log(f"  B {BATCH} S {s_dim} K {k} D {d} P {p}; t_th {params.t_th} "
        f"v_th {params.v_th}")

    # doc_sketch on the batch.
    dsk = ops.doc_sketch(b_ids, b_vals, d, s_dim)
    check_equal(torch, "doc_sketch", dsk,
                ref.doc_sketch(b_ids, b_vals, d, s_dim))
    # The wrapper's host path is longer than the kernel, so back-to-back
    # calls (ms, as the fits make them) time the host; graph_ms is the
    # kernel's device time, empty_launch_ms an empty kernel's, both timed
    # in a CUDA graph.
    rows["doc_sketch"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.doc_sketch(b_ids, b_vals, d, s_dim)),
        plain_ms=time_ms(torch, lambda: ref.doc_sketch(b_ids, b_vals, d,
                                                       s_dim), reps=3),
        library_ms=None,
        bound=bound_ms(BATCH * p * 8 + BATCH * s_dim * 4, 2 * b_nnz),
        extra=dict(
            graph_ms=graph_ms(torch, lambda: ops.doc_sketch(b_ids, b_vals, d,
                                                            s_dim)),
            empty_launch_ms=empty_launch_ms(torch)))

    # sketch_sim: the sketch gate's product, and a pair count (0/1 operands).
    sk_t = index.sketch_t
    got = ops.sketch_sim(dsk, sk_t)
    check_equal(torch, "sketch_sim", got, ref.sketch_sim(dsk, sk_t))
    ones_d, ones_m = (dsk > 0).float(), (sk_t > 0).float()
    pairs = ops.sketch_sim(ones_d, ones_m)
    check_equal(torch, "sketch_sim pairs", pairs,
                ref.sketch_sim(ones_d, ones_m))
    require(torch.equal(pairs, (ones_d.double() @ ones_m.double()).float()),
            "sketch_sim pair counts are not exact")
    lib = torch.matmul(dsk, sk_t)
    log(f"  sketch_sim bitwise equal to plain; torch.matmul (no TF32) max "
        f"abs diff {max_err(torch, lib, got):.3g}")
    # bounds-esicp's Region-3 product: the doc tail at t_th against the
    # means' Region-3 sketch; the tail's groups below t_th are zero in
    # every document, which the kernel's zero skip leaves out.
    r3 = region3_sketch(index)
    tail = torch.where(b_ids >= params.t_th, b_vals, 0.0)
    dsk_tail = ops.doc_sketch(b_ids, tail, d, s_dim)
    got_r3 = ops.sketch_sim(dsk_tail, r3)
    check_equal(torch, "sketch_sim region 3", got_r3,
                ref.sketch_sim(dsk_tail, r3))
    ones_t = (dsk_tail > 0).float()
    check_equal(torch, "sketch_sim region 3 pairs",
                ops.sketch_sim(ones_t, (r3 > 0).float()),
                ref.sketch_sim(ones_t, (r3 > 0).float()))

    def live_share(x):
        """Share of (warp, s) pairs the kernel computes: a warp's 16 rows
        are rows 8w..8w+7 of each 64-row half of a 128-row tile."""
        x = torch.nn.functional.pad(x, (0, 0, 0, (-x.shape[0]) % 128))
        x = x.view(-1, 2, 8, 8, x.shape[1]) != 0
        return float(x.any(3).any(1).float().mean())

    ops_n = 2 * BATCH * s_dim * k
    r3_ms = time_ms(torch, lambda: ops.sketch_sim(dsk_tail, r3))
    log(f"  sketch_sim region 3 (t_th {params.t_th}) bitwise equal to "
        f"plain; live (warp, s) share: gate {live_share(dsk):.4f}, region 3 "
        f"{live_share(dsk_tail):.4f}; region-3 call {r3_ms:.3f} ms")
    rows["sketch_sim"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.sketch_sim(dsk, sk_t)),
        plain_ms=time_ms(torch, lambda: ref.sketch_sim(dsk, sk_t), reps=3),
        library_ms=time_ms(torch, lambda: torch.matmul(dsk, sk_t)),
        bound=bound_ms((BATCH * s_dim + s_dim * k + BATCH * k) * 4, ops_n),
        # Without fused multiply-adds each of the ops_n operations is one
        # FP32 instruction, at half the fused rate.
        extra=dict(no_fma_floor_ms=ops_n / (peaks().fp32_flops / 2) * 1e3,
                   region3_ms=r3_ms))
    del got, pairs, lib, got_r3, dsk_tail, tail

    # The ta variant with v_ta = ρ_self / ||x||_1 (as _ta_icp forms it).
    l1 = b_vals.sum(dim=1, dtype=torch.float64).to(torch.float32)
    v_ta = (torch.clamp(model.rho_self[:BATCH], min=0.0)
            / torch.clamp(l1, min=1e-12)).contiguous()
    log(f"  v_ta: min {float(v_ta.min()):.4g} median "
        f"{float(v_ta.median()):.4g} max {float(v_ta.max()):.4g}")
    got = ops.esicp_gather(b_ids, b_vals, means_t, params.t_th, 0.0,
                           with_counts=True, v_ta=v_ta)
    want = ref.esicp_gather(b_ids, b_vals, means_t, params.t_th, 0.0,
                            with_counts=True, v_ta=v_ta)
    for nm, g, w in zip(("rho12", "y", "sims", "counts"), got, want):
        check_equal(torch, f"esicp_gather_ta.{nm}", g, w)
    rows["esicp_gather_ta"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.esicp_gather(
            b_ids, b_vals, means_t, params.t_th, 0.0, with_counts=True,
            v_ta=v_ta)),
        plain_ms=time_ms(torch, lambda: ref.esicp_gather(
            b_ids, b_vals, means_t, params.t_th, 0.0, with_counts=True,
            v_ta=v_ta), reps=3),
        library_ms=None,
        bound=bound_ms(uniq * k * 4 + BATCH * p * 8 + BATCH * 4
                       + BATCH * k * 16, 2 * 4 * b_nnz * k))
    del got, want

    # The square variant as CS-ICP calls it: 1 on the tail slots (dead
    # slots included when t_th is 0), m² gathered.
    ones = (b_ids >= params.t_th).to(torch.float32)
    got, _ = ops.sparse_sim(b_ids, ones, means_t, square=True)
    want, _ = ref.sparse_sim(b_ids, ones, means_t, square=True)
    check_equal(torch, "sparse_sim_square", got, want)
    n_tail = int((ones != 0).sum())
    tail_rows = int(torch.unique(b_ids[ones != 0]).numel())
    rows["sparse_sim_square"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.sparse_sim(b_ids, ones, means_t,
                                                 square=True)),
        plain_ms=time_ms(torch, lambda: ref.sparse_sim(
            b_ids, ones, means_t, square=True), reps=3),
        library_ms=None,
        bound=bound_ms(tail_rows * k * 4 + BATCH * p * 8 + BATCH * k * 4,
                       3 * n_tail * k))
    log_square_bytes(torch, b_ids, ones != 0, d, k, n_tail, tail_rows,
                     rows["sparse_sim_square"]["ms"])
    # t_th 0: the dead id-0 slots at the end of a row are live too, so the
    # rows' ids do not ascend: the tile takes each row's head and adds the
    # id-0 slots after it slot by slot.
    ones0 = (b_ids >= 0).to(torch.float32)
    got0, _ = ops.sparse_sim(b_ids, ones0, means_t, square=True)
    check_equal(torch, "sparse_sim_square t_th 0", got0,
                ref.sparse_sim(b_ids, ones0, means_t, square=True)[0])
    unordered = int((b_ids[:, 1:] < b_ids[:, :-1]).any(dim=1).sum())
    ms0 = time_ms(torch, lambda: ops.sparse_sim(b_ids, ones0, means_t,
                                                square=True), reps=3)
    log(f"  square variant at t_th 0 bitwise equal to plain: {unordered} of "
        f"{BATCH} rows do not ascend; {ms0:.3f} ms")
    rows["sparse_sim_square"]["extra"] = dict(t_th0_ms=ms0)
    del got, want, got0
    for name, r in rows.items():
        log(f"  {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound"
            f" {r['bound'][0]:.4f} ms by {r['bound'][1]}, library "
            f"{r['library_ms']}{extra_text(r)}) bitwise equal to plain")
    log(f"sketch kernel checks passed in {time.perf_counter() - t0:.1f} s")
    return rows


def _ivf_config(ivf_iter: int):
    from repro_torch.cluster import ClusterConfig

    return ClusterConfig(k=NYT_K, coarse_k=IVF_COARSE_K, n_probe=1,
                         algo="esicp", max_iter=ivf_iter, batch_size=BATCH,
                         chunk_size=STREAM_CHUNK)


def _log_ivf_fit(torch, res, wall: float, peak: int, base: int,
                 matrix: int) -> None:
    model = res.model
    meta = model.cell_meta
    fitted = [m for m in meta if m["n_docs"]]
    fine_s = [sum(h["elapsed_s"] for h in hs) for hs in res.cell_histories]
    sizes = [m["n_docs"] for m in fitted]
    # A cell iteration's seconds, with EstParams (iterations 1-2) and
    # without.
    est = [h["elapsed_s"] for hs in res.cell_histories for h in hs[:2]]
    later = [h["elapsed_s"] for hs in res.cell_histories for h in hs[2:]]
    log(f"  fit {wall:.3f} s: coarse fit {res.n_iter} iterations "
        f"{sum(h['elapsed_s'] for h in res.history):.3f} s; {len(fitted)} "
        f"of {model.coarse_k} cells fitted, the fine fits' sum "
        f"{sum(fine_s):.3f} s (max {max(fine_s):.3f} s, iterations "
        f"{sum(m['n_iter'] for m in fitted)}, "
        f"{sum(m['converged'] for m in fitted)} converged); cell documents "
        f"min {min(sizes)} median {int(statistics.median(sizes))} max "
        f"{max(sizes)}; K_eff {model.index.k}, cmax "
        f"{int(model.cell_sizes.max())}")
    log(f"  a cell iteration: with EstParams (iterations 1-2) mean "
        f"{statistics.mean(est):.4f} s over {len(est)}; later mean "
        f"{statistics.mean(later) if later else 0.0:.4f} s over "
        f"{len(later)}")
    log(f"  peak device memory: {peak / 2**30:.2f} GiB ({peak / matrix:.3f} "
        f"(D, K) matrices; above what was allocated before the fit "
        f"{(peak - base) / matrix:.3f})")


def routed_work(torch, ids, vals, nnz, cells, starts, sizes) -> dict:
    """The work of one routed_scan call on this batch: a multiply and an
    add per live tuple and live candidate; the bytes: each distinct
    (term, probed cell) block of means once, the live tuples, the per-row
    operands and outputs.  Beside them ``requests``: the 32-byte sectors
    of means that the kernel's blocks ask of L2 (each (document, probe)
    pair reads its cell's block of every live term's row; no block shares
    a read with another)."""
    b, p = ids.shape
    k_c, n_probe = sizes.shape[0], cells.shape[1]
    live = (torch.arange(p, device=ids.device)[None, :] < nnz[:, None]) & \
        (vals != 0)
    n_live = live.sum(1)
    cand = sizes[cells.long()].sum(1)
    flops = 2 * float((n_live * cand).sum())
    pairs = torch.unique((ids.long()[:, :, None] * k_c
                          + cells.long()[:, None, :])[live])
    blocks = float(sizes[(pairs % k_c)].double().sum()) * 4
    first = starts[cells.long()] * 4 // 32
    last = (starts[cells.long()] + sizes[cells.long()] - 1) * 4 // 32
    sectors = (last - first + 1).sum(1)
    requests = float((n_live * sectors).double().sum()) * 32
    n_bytes = (blocks + int(n_live.sum()) * 8 + b * (4 + 4 * n_probe + 12)
               + k_c * 8)
    return dict(flops=flops, bytes=n_bytes, blocks=blocks, requests=requests,
                mean_candidates=float(cand.float().mean()))


def ivf_phase(torch, docs, df, ivf_iter: int, seed: int, flat_peak: int):
    """The two-level fit at the NYT widths (k 10,000, K_c 100), the routed
    classify at n_probe 1, 4 and K_c against the flat classify, the
    routed_scan kernel against its plain version (n_probe 1, 4, the batch
    sorted by cell, n_probe K_c), and the model behind a
    ClusterServer.  Counters are zeroed before the fit and read after the
    classifies.  Returns (launches with the graph replays, the
    routed_scan row, the model)."""
    import numpy as np

    from repro_torch.cluster import classify_docs, classify_docs_routed
    from repro_torch.cluster.two_level import two_level_fit
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import ClusterEngine, ClusterServer

    t0 = phase(f"two-level: fit k={NYT_K} coarse_k={IVF_COARSE_K} esicp "
               f"(max_iter {ivf_iter}) + routed classify, N={docs.n_docs}")
    matrix = docs.dim * NYT_K * 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t = time.perf_counter()
    res = two_level_fit(docs, _ivf_config(ivf_iter), df=df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    model = res.model
    _log_ivf_fit(torch, res, wall, peak, base, matrix)
    log(f"  the flat fit's peak (phase 5): {flat_peak / 2**30:.2f} GiB "
        f"({flat_peak / matrix:.3f} (D, K) matrices)")
    require(peak < 80e9, f"two-level fit: peak {peak} bytes above 80 GB")
    require(peak <= flat_peak, "two-level fit: peak above the flat fit's")
    require(int(model.cell_sizes.sum()) == model.index.k
            and model.labels.shape == (docs.n_docs,)
            and bool(((model.labels >= 0)
                      & (model.labels < model.index.k)).all())
            and bool(torch.isfinite(model.rho_self).all()),
            "two-level fit: malformed model")
    fit_counts = dict(ops.LAUNCHES)

    def timed(fn):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (a_flat, s_flat), flat_s = timed(lambda: classify_docs(
        model.index, docs, batch_size=BATCH))
    log(f"  flat classify over K_eff {model.index.k}: {flat_s:.4f} s")
    for n_probe in IVF_PROBES:
        (a, s, sc), secs = timed(lambda: classify_docs_routed(
            model, docs, n_probe=n_probe, batch_size=BATCH, with_stats=True))
        hit = a == a_flat
        scf = sc.float()
        log(f"  routed classify n_probe {n_probe}: {secs:.4f} s "
            f"({flat_s / secs:.2f}x the flat), recall@1 against flat "
            f"{float(hit.float().mean()):.6f}, scored mean "
            f"{float(scf.mean()):.1f} max {int(sc.max())} of "
            f"{model.index.k}")
        require(torch.equal(s[hit], s_flat[hit]),
                f"n_probe {n_probe}: a winner's sim differs from the flat")
        require(bool((s <= s_flat).all()),
                f"n_probe {n_probe}: a routed sim above the flat best")
        require(int(sc.max()) <= IVF_COARSE_K
                + n_probe * int(model.cell_sizes.max()), "scored too high")
        if n_probe == IVF_COARSE_K:
            require(torch.equal(a, a_flat) and torch.equal(s, s_flat),
                    "n_probe = K_c differs from the flat classify")
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    log(f"  kernel launches: fit {fit_counts}, fit + classifies {launches}")
    log(f"  plain-version calls: {plain}")
    require(all(launches[n] > 0 for n in PATH_KERNELS["two_level"]),
            f"two-level: a kernel of its path never launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"two-level: a plain version ran: {plain}")
    log("  every winner's sim equals the flat one bit for bit; n_probe = "
        "K_c is the flat classify bit for bit")

    # The routed scan on one batch, n_probe 1 and 4; then the batch sorted
    # by its best cell (n_probe 1) and at n_probe = K_c.
    coarse_t, means_t, starts, sizes, cmax = model._routed_operands()
    b_ids = docs.ids[:BATCH].contiguous()
    b_vals = docs.vals[:BATCH].contiguous()
    b_nnz = docs.nnz[:BATCH].contiguous()
    csims = ops.sparse_sim(b_ids, b_vals, coarse_t)[0]
    order = torch.sort(csims, dim=1, descending=True, stable=True).indices
    by_cell = torch.sort(order[:, 0], stable=True).indices
    row = None
    for n_probe, sort in ((1, False), (4, False), (1, True),
                          (IVF_COARSE_K, False)):
        sel = by_cell if sort else slice(None)
        cells = order[sel, :n_probe].to(torch.int32).contiguous()
        args = (b_ids[sel].contiguous(), b_vals[sel].contiguous(),
                b_nnz[sel].contiguous(), means_t, cells, starts, sizes,
                cmax)
        what = f"n_probe {n_probe}" + (", sorted by cell" if sort else "")
        got = ops.routed_scan(*args)
        want = ref.routed_scan(*args)
        for nm, g, w in zip(("assign", "best", "scored"), got, want):
            check_equal(torch, f"routed_scan.{nm} {what}", g, w)
        if not sort:
            check_equal(torch, "routed_scan vs classify_docs_routed", got[0],
                        classify_docs_routed(model, docs.slice_rows(0, BATCH),
                                             n_probe=n_probe)[0])
        work = routed_work(torch, *args[:3], cells, starts, sizes)
        r = dict(max_abs_err=0.0,
                 ms=time_ms(torch, lambda: ops.routed_scan(*args)),
                 plain_ms=(time_ms(torch, lambda: ref.routed_scan(*args),
                                   reps=3) if n_probe < IVF_COARSE_K
                           else None),
                 library_ms=None,
                 bound=bound_ms(work["bytes"], work["flops"]),
                 extra=dict(n_probe=n_probe, cmax=cmax,
                            mean_candidates=work["mean_candidates"],
                            means_block_bytes=work["blocks"],
                            means_request_bytes=work["requests"]))
        plain = ("not timed" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.3f} ms")
        log(f"  routed_scan {what}: {r['ms']:.4f} ms (plain {plain}, "
            f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}: "
            f"{work['flops']:.4g} flops, "
            f"{work['bytes']:.4g} bytes of which {work['blocks']:.4g} "
            f"distinct means blocks; the tiles request "
            f"{work['requests']:.4g} bytes of means sectors), bitwise "
            f"equal to plain")
        if row is None:
            row = r
            # The one-column path (K not a multiple of 4, or means_t not
            # 16-byte aligned) on the same work: means_t 4 bytes past a
            # 16-byte boundary.
            shifted = torch.empty((means_t.numel() + 1,),
                                  dtype=torch.float32,
                                  device=means_t.device)[1:]
            shifted = shifted.view(means_t.shape)
            shifted.copy_(means_t)
            one = (*args[:3], shifted, *args[4:])
            for nm, g, w in zip(("assign", "best", "scored"),
                                ops.routed_scan(*one), want):
                check_equal(torch, f"routed_scan.{nm} {what}, one column "
                            f"a thread", g, w)
            row["extra"]["ms_one_column"] = time_ms(
                torch, lambda: ops.routed_scan(*one))
            log(f"  routed_scan {what}, one column a thread: "
                f"{row['extra']['ms_one_column']:.4f} ms, bitwise equal to "
                f"plain")
            del shifted, one
        else:
            tag = "_sorted" if sort else f"_n_probe_{n_probe}"
            row["extra"].update({f"ms{tag}": r["ms"],
                                 f"bound_ms{tag}": r["bound"][0]})
    del csims, order

    # Routed serving: 8 clients against the two-level model.
    rows_h = (docs.ids.cpu().numpy(), docs.vals.cpu().numpy(),
              docs.nnz.cpu().numpy())
    want_a, want_s = (x.cpu().numpy() for x in classify_docs_routed(
        model, docs, batch_size=BATCH))
    srv = ClusterServer(max_live_batches=4, batch_timeout_s=0.002,
                        n_post_workers=2)
    try:
        t = time.perf_counter()
        sv = srv.load("ivf", model, pad_width=docs.pad_width)
        torch.cuda.synchronize()
        ones = dict.fromkeys(sv.sorted_batch_sizes, 1)
        log(f"  serving: built and captured in {time.perf_counter() - t:.3f}"
            f" s; capture s by bucket "
            f"{ {b: round(v, 4) for b, v in sv.capture_s.items()} }")
        require(sv.capture_counts() == ones, f"captures {sv.capture_counts()}")
        before = dict(ops.LAUNCHES)
        sv.reset_replay_counts()
        lat, wall, answers = _drive_clients(
            srv, "ivf", rows_h, _client_plan(docs.n_docs, seed + 2,
                                             SERVE_REQUESTS))
        replays = sv.replay_counts()
        log(f"  serving traffic: {_traffic_line(srv, 'ivf', answers, lat, wall)}")
        log(f"  replays by bucket {replays}; captures {sv.capture_counts()}")
        require(ops.LAUNCHES == before, "an eager launch during the traffic")
        require(sv.capture_counts() == ones, "a bucket was captured again")
        require(sum(replays.values()) == srv.stats("ivf")["n_batches"],
                f"replays {replays} against the batches")
        require(srv.stats("ivf")["n_failures"] == 0, "a request failed")
        for rows, a, s in answers:
            require(np.array_equal(a, want_a[rows])
                    and np.array_equal(s, want_s[rows]),
                    "a served answer differs from classify_docs_routed")
        log(f"  {len(answers)} served answers equal classify_docs_routed "
            f"bit for bit")
    finally:
        srv.close()
    del sv
    try:
        ClusterEngine.from_model(model, batch_size=BATCH).refit(docs)
        require(False, "ClusterEngine.refit ran on a two-level model")
    except NotImplementedError as e:
        require("coarse" in str(e), f"refit refused without naming the "
                f"coarse level: {e}")
        log(f"  ClusterEngine.refit refuses the two-level model: {e}")
    for name in ("sparse_sim", "routed_scan"):
        launches[name] += sum(replays.values())
    log(f"two-level phase done in {time.perf_counter() - t0:.1f} s")
    return launches, row, model


def ivf_store_phase(torch, store, df, ivf_iter: int, model) -> dict:
    """The two-level fit over the disk store (coarse streaming fit, cells as
    SubsetStore views) against the resident two-level fit, bit for bit."""
    from repro_torch.cluster.two_level import two_level_fit
    from repro_torch.kernels import ops

    t0 = phase(f"two-level over the disk store (SubsetStore cells), "
               f"N={store.n_docs}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t = time.perf_counter()
    res = two_level_fit(store, _ivf_config(ivf_iter), df=df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    _log_ivf_fit(torch, res, wall, torch.cuda.max_memory_allocated(), base,
                 store.dim * NYT_K * 4)
    log(f"  kernel launches: {launches}; plain-version calls {plain}")
    require(all(launches[n] > 0 for n in PATH_KERNELS["two_level store"]),
            f"two-level store: a kernel never launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"two-level store: a plain version ran: {plain}")
    got = res.model
    require(torch.equal(got.labels, model.labels)
            and torch.equal(got.rho_self, model.rho_self)
            and got.cell_meta == model.cell_meta
            and torch.equal(got.coarse_index.means_t,
                            model.coarse_index.means_t),
            "two-level store fit: labels, ρ, cells or coarse means differ "
            "from the resident fit")
    _, err, same = chunked_compare(torch, got.index.means_t,
                                   model.index.means_t, 0.0)
    require(same, f"two-level store fit: fine means differ (max {err})")
    log("  labels, ρ_self, cell provenance, coarse and fine means equal the "
        "resident two-level fit bit for bit")
    log(f"two-level store phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def _same_history(a, b, what: str) -> None:
    """Every history field but elapsed_s, iteration by iteration."""
    require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} iterations")
    for r, (ha, hb) in enumerate(zip(a, b)):
        strip = lambda h: {f: v for f, v in h.items() if f != "elapsed_s"}
        require(strip(ha) == strip(hb), f"{what}: history differs at "
                f"iteration {r + 1}: {ha} vs {hb}")


def _same_means(torch, got, want_host, what: str) -> None:
    """(D, K) means on the card bit for bit against a host copy, row chunk
    by row chunk."""
    from repro_torch.core.meanindex import row_chunks

    for s, e in row_chunks(*got.shape):
        require(torch.equal(got[s:e], want_host[s:e].to(got.device)),
                f"{what}: means differ in rows [{s}, {e})")


def resident_record(torch, model, cls) -> dict:
    """What the streaming phase holds its fit to, on the host: phase 5's
    trajectory, history, ρ_self, means, classify labels and sims."""
    t = time.perf_counter()
    rec = dict(traj=model.trajectory, history=model.history,
               rho=model.rho_self.cpu(), means=model.index.means_t.cpu(),
               labels=cls[0].cpu(), sims=cls[1].cpu())
    log(f"  resident fit kept on the host for the streaming phase "
        f"({time.perf_counter() - t:.1f} s)")
    return rec


def write_store(docs_h, tmp: str):
    """The corpus as a disk DocStore under ``tmp``, reopened memmapped;
    fails up front when the disk cannot hold it."""
    from repro_torch.sparse.store import DocStore

    # Below 4 chunks of STREAM_CHUNK rows (a cut run), chunks of a multiple
    # of 2048 rows that make at least 4, so the accumulating launch runs.
    n = docs_h.n_docs
    chunk = (STREAM_CHUNK if n >= 4 * STREAM_CHUNK
             else max(2048, -(-n // 4) // 2048 * 2048))
    mem = DocStore.from_docs(docs_h, chunk_size=chunk)
    free = shutil.disk_usage(tmp).free
    require(free > 2 * mem.nbytes + (1 << 30),
            f"{tmp} has {free} bytes free; the {mem.n_chunks}-chunk store "
            f"needs {mem.nbytes} (twice that plus 1 GiB asked)")
    t = time.perf_counter()
    store = mem.save(tmp)
    on_disk = sum(os.path.getsize(os.path.join(tmp, f))
                  for f in os.listdir(tmp))
    log(f"  disk store: {store.n_docs} documents in {store.n_chunks} chunks "
        f"of {chunk} rows ({store.n_rows - store.n_docs} dead tail "
        f"rows), {on_disk} bytes ({on_disk / 1e9:.3f} GB) written in "
        f"{time.perf_counter() - t:.1f} s; {free / 1e9:.1f} GB were free")
    return store


def init_kernel_row(torch, store, assign, means_t) -> dict:
    """segment_update's accumulating launch on a store chunk with the
    fitted labels, onto a copy of the fitted means: against its plain
    version on the card (1e-4: index_add_ there uses atomics) and bit for
    bit against the CPU plain version at 20,000 documents x K 1,000."""
    from repro_torch.kernels import ops, ref
    from repro_torch.sparse.matrix import SparseDocs

    d, k = means_t.shape
    c0 = store.chunk(0, device="cuda").slice_rows(0, store.n_valid(0))
    a0 = assign[:c0.n_docs].contiguous()
    live = c0.live_vals()
    lam = means_t.clone()
    got = ops.segment_update(a0, c0, k=k, init=lam)
    want = ref.segment_update(a0, c0.ids, live, k, d, init=means_t.clone())
    ok, err, _ = chunked_compare(torch, got, want, 1e-4)
    require(ok, f"segment_update init: max abs err {err} above 1e-4")
    del want
    ms = time_ms(torch, lambda: ops.segment_update(a0, c0, k=k, init=lam))
    plain_ms = time_ms(torch, lambda: ref.segment_update(
        a0, c0.ids, live, k, d, init=lam), reps=3)
    sel = ((a0 >= 0) & (a0 < k))[:, None] & (live != 0)
    flat = (c0.ids.long() * k + a0.long()[:, None])[sel]
    fvals = live[sel]
    lib_ms = time_ms(torch, lambda: lam.view(-1).index_add_(0, flat, fvals),
                     reps=3)
    touched = int(torch.unique(c0.ids[sel]).numel())
    cells = int(torch.unique(flat).numel())
    n_live = int(sel.sum())
    del lam, flat, fvals
    torch.cuda.empty_cache()

    n_h, k_h = min(20_000, c0.n_docs), 1_000
    gen = torch.Generator(device="cuda").manual_seed(7)
    h_docs = SparseDocs(c0.ids[:n_h].contiguous(), c0.vals[:n_h].contiguous(),
                        c0.nnz[:n_h].contiguous(), d)
    h_assign = torch.randint(0, k_h, (n_h,), generator=gen, device="cuda",
                             dtype=torch.int32)
    h_assign[::97] = k_h
    h_init = torch.randn((d, k_h), generator=gen, device="cuda")
    got = ops.segment_update(h_assign, h_docs, k=k_h,
                             init=h_init.clone()).cpu()
    want = ref.segment_update(h_assign.cpu(), h_docs.ids.cpu(),
                              h_docs.live_vals().cpu(), k_h, d,
                              init=h_init.cpu())
    require(torch.equal(got, want), "segment_update init: differs from the "
            f"CPU plain version at {n_h} documents, K {k_h}")
    del got, want, h_init
    log(f"  segment_update init: chunk of {c0.n_docs} documents, {n_live} "
        f"live tuples over {touched} touched terms and {cells} touched "
        f"(term, cluster) cells; bitwise equal to the CPU plain version at "
        f"{n_h} documents x K {k_h}")
    return dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        # the function's bytes: the chunk's postings (id, value) and
        # assignments read once, each touched (term, cluster) cell read and
        # written once
        bound=bound_ms(n_live * 8 + c0.n_docs * 4 + cells * 8, n_live),
        extra=dict(touched_terms=touched, touched_cells=cells,
                   chunk_rows=c0.n_docs))


def copy_pass_s(torch, store, depth: int) -> float:
    """Seconds of a bare prefetcher pass over the store, no compute: how
    fast the host reads chunks and copies them to the card."""
    from repro_torch.sparse.store import ChunkPrefetcher

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in ChunkPrefetcher(store, depth=depth):
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t


def streaming_phase(torch, store, docs_h, df, resident, refit_rec,
                    max_iter: int):
    """streaming_fit over the disk store against phase 5's resident fit,
    then classify, transform and the UC diagnostics over it, and one
    ``ClusterEngine.refit`` round over it against the serving phase's
    resident refit."""
    from repro_torch.cluster import FittedModel, classify_docs, transform_docs
    from repro_torch.core import metrics
    from repro_torch.core.lloyd import streaming_fit
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.kernels import ops
    from repro_torch.serve import ClusterEngine
    from repro_torch.sparse.matrix import term_major
    from repro_torch.sparse.store import DocStore

    t0 = phase(f"streaming: streaming_fit k={NYT_K} esicp over the disk "
               f"store, N={store.n_docs}")
    seed_rows = draw_seed_rows(store.n_docs, NYT_K, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res = streaming_fit(store, k=NYT_K, algo="esicp", max_iter=max_iter,
                        batch_size=BATCH, seed_rows=seed_rows, df=df,
                        device="cuda", keep_trajectory=True)
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    peak = torch.cuda.max_memory_allocated()
    matrix = store.dim * NYT_K * 4
    for h in res.history:
        log("  " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                               for k, v in h.items()}))
    log(f"  seconds per iteration: streaming "
        f"{[round(h['elapsed_s'], 3) for h in res.history]}, resident "
        f"{[round(h['elapsed_s'], 3) for h in resident['history']]}")
    log(f"  prefetch, per iteration: host seconds waiting on chunks "
        f"{[round(w, 4) for w in res.prefetch['wait_s']]}; chunks whose "
        f"copy was not done when taken {res.prefetch['late']} (of "
        f"{2 * store.n_chunks}: the assignment and ρ passes; EstParams' pass "
        f"is not counted)")
    log(f"  peak device memory: {peak / 2**30:.2f} GiB ({peak / matrix:.3f} "
        f"(D, K) matrices); allocated before the fit {base / 2**30:.3f} GiB")
    log(f"  kernel launches: {launches}")
    log(f"  plain-version calls: {plain}")
    require(all(launches[n] > 0 for n in PATH_KERNELS["streaming"]),
            f"streaming: a kernel of its path never launched: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"streaming: a plain version ran: {plain}")
    require(res.n_iter == len(resident["traj"]),
            f"streaming: {res.n_iter} iterations, resident "
            f"{len(resident['traj'])}")
    for r, (a, b) in enumerate(zip(res.trajectory, resident["traj"])):
        require(torch.equal(a, b), f"streaming: assignment differs from "
                f"the resident fit at iteration {r + 1}")
    _same_history(res.history, resident["history"], "streaming")
    require(torch.equal(res.state.rho_self.cpu(), resident["rho"]),
            "streaming: ρ_self differs from the resident fit")
    _same_means(torch, res.state.index.means_t, resident["means"],
                "streaming")
    log(f"  assignments at all {res.n_iter} iterations, ρ_self, means and "
        f"history (but elapsed_s) equal the resident fit bit for bit")
    for r, (p, h) in enumerate(zip(res.passes, res.history), 1):
        log(f"  iteration {r}, seconds by pass (device timeline): "
            + ", ".join(f"{name} {sec:.4f}" for name, sec in p.items())
            + f"; wall {h['elapsed_s']:.4f}")
    copy_pass_s(torch, store, 2)                         # page cache warm
    log(f"  a bare copy pass over the store: depth 2 "
        f"{copy_pass_s(torch, store, 2):.3f} s, depth 4 "
        f"{copy_pass_s(torch, store, 4):.3f} s")

    c0 = store.chunk(0, device="cuda").slice_rows(0, store.n_valid(0))
    layout_ms = time_ms(torch, lambda: term_major(c0.ids, c0.live_vals(),
                                                  d=store.dim), reps=3)
    log(f"  term-major layout of one {c0.n_docs}-row chunk: "
        f"{layout_ms:.3f} ms (built per chunk per pass: "
        f"{store.n_chunks} a plain iteration)")
    del c0
    row = init_kernel_row(torch, store, res.assign, res.state.index.means_t)
    row["extra"]["layout_ms"] = layout_ms

    index = res.state.index
    t = time.perf_counter()
    labels, sims = classify_docs(index, store, batch_size=BATCH)
    torch.cuda.synchronize()
    cls_s = time.perf_counter() - t
    require(torch.equal(labels.cpu(), resident["labels"])
            and torch.equal(sims.cpu(), resident["sims"]),
            "classify over the store differs from the resident classify")
    head = docs_h.slice_rows(0, BATCH)
    got = transform_docs(index, DocStore.from_docs(head), batch_size=BATCH)
    want = ops.sparse_sim(head.ids.cuda(), head.vals.cuda(),
                          index.means_t)[0]
    require(torch.equal(got, want), "transform over the one-chunk store "
            "differs from the resident sims")
    del got, want
    log(f"  classify over the store: {cls_s:.3f} s, equal to the resident "
        f"classify; transform of the first {BATCH} rows equal to the "
        f"resident sims")
    docs_d = docs_h.to("cuda")
    nr, cps, _ = metrics.cps_curve(docs_d, index.means_t, res.assign)
    skew = metrics.mean_value_skew(index.means_t)
    nmi = metrics.nmi(res.assign, resident["traj"][-1])
    del docs_d
    require(abs(nmi - 1.0) < 1e-12, f"NMI(streaming, resident) = {nmi}")
    log(f"  CPS(0.1) {cps[10]:.4f} (PubMed in the paper: ≈ 0.92), CPS(0.2) "
        f"{cps[20]:.4f}, CPS(0.5) {cps[50]:.4f}; mean_value_skew {skew}; "
        f"NMI(streaming, resident) {nmi}")

    # One refit round over the store, from the streaming fit's index (its
    # means and thresholds are the main fit's, held above), counted on its
    # own: the serving phase's resident refit bit for bit.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    engine = ClusterEngine.from_model(FittedModel(index=index),
                                      batch_size=BATCH)
    t = time.perf_counter()
    r_assign, r_rho = engine.refit(store, n_iter=1)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t
    refit_launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    log(f"  store refit (1 round, {store.n_chunks} chunks): {refit_s:.3f} s,"
        f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches { {k: v for k, v in refit_launches.items() if v} }; "
        f"plain-version calls { {k: v for k, v in plain.items() if v} }")
    require(all(refit_launches[n] > 0 for n in PATH_KERNELS["store refit"]),
            f"store refit: a kernel of its path never launched: "
            f"{refit_launches}")
    require(all(v == 0 for v in plain.values()),
            f"store refit: a plain version ran: {plain}")
    require(torch.equal(r_assign.cpu(), refit_rec["assign"])
            and torch.equal(r_rho.cpu(), refit_rec["rho"]),
            "store refit: assign or ρ differ from the resident refit")
    _same_means(torch, engine.index.means_t, refit_rec["means"],
                "store refit")
    log("  store refit equals the resident refit bit for bit (assign, ρ, "
        "means)")
    del engine, r_assign, r_rho
    torch.cuda.empty_cache()
    log(f"streaming phase done in {time.perf_counter() - t0:.1f} s")
    return launches, row, seed_rows, refit_launches


def minibatch_phase(torch, store, seed_rows):
    """Two minibatch passes over the disk store at full width."""
    from repro_torch.core.lloyd import streaming_fit
    from repro_torch.kernels import ops

    t0 = phase(f"minibatch: 2 passes of algo_mode='minibatch', k={NYT_K}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    res = streaming_fit(store, k=NYT_K, algo_mode="minibatch", max_iter=2,
                        batch_size=BATCH, seed_rows=seed_rows,
                        device="cuda")
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    peak = torch.cuda.max_memory_allocated()
    matrix = store.dim * NYT_K * 4
    obj = [h["objective"] for h in res.history]
    log(f"  objective per pass {obj}; changed per pass "
        f"{[h['n_changed'] for h in res.history]}; seconds per pass "
        f"{[round(h['elapsed_s'], 3) for h in res.history]}")
    log(f"  peak device memory: {peak / 2**30:.2f} GiB ({peak / matrix:.3f} "
        f"(D, K) matrices)")
    log(f"  kernel launches: {launches}; plain-version calls: {plain}")
    require(len(obj) == 2 and obj[1] >= obj[0],
            f"minibatch: the objective fell: {obj}")
    require(peak < 4 * matrix, f"minibatch: peak {peak} bytes holds a "
            f"fourth (D, K) matrix")
    allowed = PATH_KERNELS["minibatch"]
    require(all(launches[n] > 0 for n in allowed)
            and all(v == 0 for n, v in launches.items() if n not in allowed),
            f"minibatch: launches outside {allowed} or missing: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"minibatch: a plain version ran: {plain}")
    log(f"minibatch phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def _rewind_to_mid_epoch(ckpt: str, n_chunks: int) -> int:
    from repro_torch.checkpoint.store import all_steps

    steps = all_steps(ckpt)
    mid = [s for s in steps if s % (n_chunks + 1) != 0]
    require(bool(mid), f"no mid-epoch checkpoint under {ckpt}: {steps}")
    for s in steps:
        if s > mid[-1]:
            shutil.rmtree(os.path.join(ckpt, f"step_{s:08d}"))
    return mid[-1]


def small_store_phase(torch, small):
    """Phase 4's card fits through a 4-chunk in-memory store, a mid-epoch
    resume and a model save/load, on the card."""
    from repro_torch.cluster import load_model
    from repro_torch.core.assignment import ALGORITHMS
    from repro_torch.core.lloyd import streaming_fit
    from repro_torch.kernels import ops
    from repro_torch.sparse.store import DocStore

    t0 = phase("small store: nine modes through a 4-chunk store, resume, "
               "save/load (card)")
    docs, df, rows = small["docs"], small["df"], small["rows"]
    store = DocStore.from_docs(docs, chunk_size=750)
    require(store.n_chunks == 4, f"{store.n_chunks} chunks")
    kw = dict(k=32, batch_size=1024, seed_rows=rows, df=df, device="cuda")
    ops.reset_counts()
    for algo in ALGORITHMS:
        want = small["fits"][algo]
        got = streaming_fit(store, algo=algo, keep_trajectory=True,
                            max_iter=30 if algo == "esicp"
                            else small["small_iter"], **kw)
        _same_fits(torch, got, want, f"store {algo}")
        _same_history(got.history, want.history, f"store {algo}")
        require(torch.equal(got.state.rho_self, want.state.rho_self)
                and torch.equal(got.state.index.means_t,
                                want.state.index.means_t),
                f"store {algo}: ρ_self or means differ")
    torch.cuda.synchronize()
    require(all(v == 0 for v in ops.PLAIN.values()),
            f"small store: a plain version ran: {ops.PLAIN}")
    log(f"  nine modes identical to the resident card fits; launches "
        f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        full = streaming_fit(store, max_iter=30, checkpoint_dir=ck,
                             checkpoint_every=1, **kw)
        step = _rewind_to_mid_epoch(ck, store.n_chunks)
        again = streaming_fit(store, max_iter=30, checkpoint_dir=ck,
                              resume=True, **kw)
    require(torch.equal(again.assign, full.assign)
            and again.n_iter == full.n_iter,
            "resume from a mid-epoch checkpoint changed the labels")
    log(f"  resumed from mid-epoch step {step} (epoch "
        f"{step // (store.n_chunks + 1) + 1}, after chunk "
        f"{step % (store.n_chunks + 1)}): identical labels over "
        f"{full.n_iter} iterations")
    model = small["model"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_") as md:
        model.save(md)
        back = load_model(md, device="cuda")
    require(torch.equal(back.index.means_t, model.index.means_t)
            and torch.equal(back.labels, model.labels)
            and torch.equal(back.predict(docs), model.predict(docs)),
            "a model saved on the card and loaded back predicts otherwise")
    log(f"  model saved and loaded on the card: identical means, labels and "
        f"predictions")
    log(f"small store phase done in {time.perf_counter() - t0:.1f} s")


def attention_bound(bh: int, sq: int, hd: int, window: int,
                    passes: float = 1):
    """(bound, live pairs) of one banded-causal attention call: 4·hd
    operations per live (query, key) pair against q, k, v read once and
    the output written once.  passes 1: fp32 on the CUDA cores; more:
    that many TF32 products per operation on the tensor cores."""
    pairs = sum(min(i + 1, window) if window >= 0 else i + 1
                for i in range(sq)) * bh
    hw = peaks()
    rate = hw.fp32_flops if passes == 1 else hw.tf32_flops
    return bound_ms(4 * bh * sq * hd * 4, passes * 4 * hd * pairs,
                    rate), pairs


def log_flash_resources() -> None:
    """Registers and spills (ptxas) and shared memory and blocks an SM of
    every flash_attention instantiation; fails on a spill."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kern

    for r in _build.ptxas_report("flash_attention"):
        hd = int(re.search(r"ILi(\d+)E", r["kernel"]).group(1))
        smem, blocks = kern.resources(hd)
        log(f"  flash_kernel<{hd}>: {r['registers']} registers, spill "
            f"stores {r['spill_stores']} B, loads {r['spill_loads']} B; "
            f"{smem} B shared memory, {blocks} block(s) an SM")
        require(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                f"flash_kernel<{hd}> spills")


def flash_case(torch, q, k, v, window: int, tol: float, what: str) -> dict:
    """flash_attention against its plain version on (q, k, v), timed beside
    the plain version, ``scaled_dot_product_attention`` and both bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    bh, s, hd = q.shape
    got = ops.flash_attention(q, k, v, window=window)
    want = ref.flash_attention(q, k, v, window)
    err = check_close(torch, f"flash_attention {what}", got, want, tol)
    del want
    if window < 0 or window >= s:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    else:
        pos = torch.arange(s, device=q.device)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[:, None] - pos[None, :] < window))
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band)
    lib_err = max_err(torch, lib(), got)
    del got
    bound, pairs = attention_bound(bh, s, hd, window, TF32_PASSES)
    fp32_bound, _ = attention_bound(bh, s, hd, window)
    r = dict(max_abs_err=err,
             ms=time_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                           window=window)),
             plain_ms=time_ms(torch, lambda: ref.flash_attention(q, k, v,
                                                                 window), reps=3),
             library_ms=time_ms(torch, lib), bound=bound,
             fp32_bound_ms=fp32_bound[0])
    log(f"  {what}: BH {bh} S {s} hd {hd} window {window}: {pairs} live "
        f"pairs; {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, sdpa "
        f"{r['library_ms']:.3f} ms); bound {bound[0]:.4f} ms by "
        f"{bound[1]} in {TF32_PASSES} TF32 passes on the tensor cores "
        f"({bound[0] / r['ms']:.1%} of it), {fp32_bound[0]:.4f} ms in "
        f"fp32 on the CUDA cores ({fp32_bound[0] / r['ms']:.1%}); max "
        f"abs err {err:.3g} (tolerance {tol}); sdpa vs kernel {lib_err:.3g}")
    return r


def _shape_record(r: dict) -> dict:
    return dict(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                bound_ms=r["bound"][0], fp32_bound_ms=r["fp32_bound_ms"],
                max_abs_err=r["max_abs_err"])


# The attention family's and zamba2's full-width prefill shapes for phase
# 12: (name, heads per row of the batch, hd, window).  mixtral's window
# 4096 equals full causal at S 4096; at 1024 a band is live at hd 128.
# zamba2's hd 80 runs the hd-128 instantiation on zero-padded operands.
FAMILY_FLASH_SHAPES = (("granite-moe-3b-a800m", 24, 64, -1),
                       ("qwen2.5-32b", 40, 128, -1),
                       ("mixtral-8x22b", 48, 128, 4096),
                       ("mixtral-8x22b window 1024", 48, 128, 1024),
                       ("zamba2-2.7b (hd 80, padded to 128)", 32, 80, -1))


def lm_kernel_phase(torch, seed: int, batch: int, seq: int):
    """flash_attention against its plain version: the model's shapes, the
    attention family's full-width shapes, padded head dims and a ragged
    shape with fully masked rows."""
    from repro_torch.kernels import ops, ref

    t0 = phase("lm kernels: flash_attention")
    log_flash_resources()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = 2e-5
    bh, s, hd = 8, 4096, 256
    q, k, v = (torch.randn((bh, s, hd), generator=gen, device=dev)
               for _ in range(3))
    by_window = {window: flash_case(torch, q, k, v, window, tol, "gemma3-1b")
                 for window in (512, -1)}
    del q, k, v
    # Scores of magnitude ≈ 30 (q, k scaled by 6): the online rescaling
    # under the split products, against the plain version in float64 (in
    # float32 it is itself 9e-5 off there; scripts/flash_probe.py).
    q6, k6, v6 = (torch.randn((2, 1024, hd), generator=gen, device=dev)
                  for _ in range(3))
    q6, k6 = q6 * 6, k6 * 6
    got = ops.flash_attention(q6, k6, v6, window=-1)
    want = ref.flash_attention(q6.double(), k6.double(), v6.double(), -1)
    err6 = check_close(torch, "flash_attention (2, 1024, 256) q, k x6",
                       got.double(), want, tol)
    err32 = max_err(torch, ref.flash_attention(q6, k6, v6, -1), want)
    log(f"  (2, 1024, 256) full causal, q, k scaled by 6 (scores ≈ 30): max "
        f"abs err against the float64 plain version {err6:.3g} (tolerance "
        f"{tol}; the float32 plain version {err32:.3g})")
    del q6, k6, v6, got, want

    # Sq != Sk, neither a multiple of the tile; rows >= 136 + 48 - 1 see
    # no key and must give exactly 0.
    q, k, v = (torch.randn((3, n, 64), generator=gen, device=dev)
               for n in (200, 136, 136))
    got = ops.flash_attention(q, k, v, window=48)
    err = check_close(torch, "flash_attention (3, 200, 136, 64) window 48",
                      got, ref.flash_attention(q, k, v, 48), tol)
    require(bool((got[:, 183:] == 0).all()) and bool((got[:, :183] != 0).any()),
            "flash_attention: the rows with no live key are not exactly 0")
    log(f"  (3, 200, 136, 64) window 48: max abs err {err:.3g} (tolerance "
        f"{tol}); rows 183-199 exactly 0")
    errs = [err, err6]

    # Head dims without an instantiation: zero-padded to the next one.
    for hd_, heads in ((12, 4), (96, 8)):
        q, k, v = (torch.randn((batch * heads, 1024, hd_), generator=gen,
                               device=dev) for _ in range(3))
        for window in (-1, 100):
            ops.reset_counts()
            got = ops.flash_attention(q, k, v, window=window)
            require(ops.LAUNCHES["flash_attention"] == 1 and got.shape == q.shape,
                    f"flash_attention at hd {hd_} did not launch once")
            e = check_close(torch, f"flash_attention hd {hd_} window {window}",
                            got, ref.flash_attention(q, k, v, window), tol)
            errs.append(e)
            log(f"  ({batch * heads}, 1024, {hd_}) window {window}, padded "
                f"to hd {16 if hd_ == 12 else 128}: max abs err {e:.3g} "
                f"(tolerance {tol})")
    del q, k, v, got

    by_shape = {}
    for name, heads, hd_, window in FAMILY_FLASH_SHAPES:
        q, k, v = (torch.randn((batch * heads, seq, hd_), generator=gen,
                               device=dev) for _ in range(3))
        r = flash_case(torch, q, k, v, window, tol, name)
        del q, k, v
        torch.cuda.empty_cache()
        errs.append(r["max_abs_err"])
        by_shape[f"{batch * heads}x{seq}x{hd_} window {window}"] = \
            _shape_record(r)
    row = dict(by_window[-1])
    row["max_abs_err"] = max(*errs,
                             *(r["max_abs_err"] for r in by_window.values()))
    row["extra"] = dict(fp32_bound_ms=row.pop("fp32_bound_ms"),
                        by_shape=by_shape)
    row["by_window"] = {str(w): _shape_record(r) for w, r in by_window.items()}
    log(f"lm kernel checks passed in {time.perf_counter() - t0:.1f} s")
    return row


def kind_counts(cfg) -> dict:
    """The kernel launches one prefill of ``cfg`` makes: flash_attention
    per attention layer or shared_attn invocation, slstm_scan per sLSTM
    layer."""
    from repro_torch.models.transformer import ATTN_KINDS, layer_specs

    kinds = [spec.kind for spec in layer_specs(cfg)]
    return {"flash_attention": sum(k in ATTN_KINDS for k in kinds),
            "slstm_scan": kinds.count("slstm")}


def lm_small_phase(torch, seed: int):
    """Every arch's smoke config, float32 compute, on the card and on the
    CPU from the same parameters: prefill logits (with a frontend prefix
    for the audio and image archs) and greedy tokens; granite's and
    mixtral's once more with the int8 KV cache."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import SSM_KINDS, init_params, tree_to
    from repro_torch.serve.lm import ServeLoop, make_prefill_fn

    t0 = phase(f"lm small cross-check (cuda vs cpu), the smoke configs of "
               f"the {len(registry.ARCHS)} archs")
    cases = [(arch, "bf16") for arch in registry.ARCHS]
    cases += [("granite-moe-3b-a800m", "int8"), ("mixtral-8x22b", "int8")]
    f32 = torch.float32
    for arch, kv in cases:
        cfg = dataclasses.replace(registry.smoke_config(arch), kv_dtype=kv)
        gen = torch.Generator().manual_seed(seed)
        params = {"cpu": init_params(cfg, gen, device="cpu")}
        params["cuda"] = tree_to(params["cpu"], "cuda")
        # B·S a multiple of the MoE smoke configs' routing group (32), S
        # of the SSM smoke configs' chunk (16); the others a ragged 37.
        ssm = any(sp.kind in SSM_KINDS for seg in cfg.segments
                  for sp in seg.layers)
        s = 48 if cfg.n_experts or ssm else 37
        want = kind_counts(cfg)
        toks = torch.randint(0, cfg.vocab, (2, s), generator=gen,
                             dtype=torch.int32)
        fe = (torch.randn((2, 5, cfg.d_model), generator=gen)
              if cfg.modality != "text" else None)
        prompts = toks[:, :8]
        lg, out = {}, {}
        for dev in ("cuda", "cpu"):
            ops.reset_counts()
            lg[dev] = make_prefill_fn(cfg, compute_dtype=f32)(
                params[dev], toks.to(dev), None if fe is None else fe.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {k: ops.LAUNCHES[k] for k in want}
                plain = sum(ops.PLAIN.values())
            out[dev] = ServeLoop(cfg, params[dev], compute_dtype=f32).generate(
                prompts.to(dev), n_new=16)
        what = f"{cfg.name} kv {kv}"
        err = check_close(torch, f"lm small prefill logits cuda vs cpu, {what}",
                          lg["cuda"].cpu(), lg["cpu"], 1e-4)
        require(launches == want and plain == 0,
                f"lm small {what}: kernel launches {launches}, expected "
                f"{want}; plain calls {plain}")
        require(torch.equal(out["cuda"].cpu(), out["cpu"]),
                f"lm small {what}: greedy tokens differ cuda vs cpu:\n"
                f"{out['cuda']}\n{out['cpu']}")
        log(f"  {what} (hd {cfg.hd}{', frontend 5' if fe is not None else ''}"
            f"): prefill logits (2, {cfg.vocab}) max abs err {err:.3g} "
            f"(tolerance 1e-4); kernel launches {launches}, plain 0; greedy "
            f"tokens identical: {out['cpu'][0, 8:].tolist()}")
    log(f"lm small cross-check passed in {time.perf_counter() - t0:.1f} s")


def device_breakdown(torch, fn):
    """(wall s, {group: device ms}, kernels) of one call of ``fn`` under
    torch.profiler: device time of the kernels it ran, grouped as the
    attention kernel, GEMMs and the rest; wall time by host clock around
    work that ends in a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    groups = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        key = ("flash_attention" if "flash_kernel" in name else
               "gemm" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        ms = e.time_range.elapsed_us() / 1e3
        groups[key] += ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        n += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall, groups, n, top


def log_breakdown(what: str, wall: float, groups: dict, n: int, top) -> None:
    busy = sum(groups.values())
    log(f"  {what}: wall {wall * 1e3:.1f} ms, {n} device kernels, device "
        f"busy {busy:.1f} ms ({busy / (wall * 1e3):.1%}; idle "
        f"{1 - busy / (wall * 1e3):.1%}): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in groups.items()))
    for name, ms in top:
        log(f"    {ms:8.2f} ms  {name[:100]}")


class plain_kernels:
    """Routes the model's attention and sLSTM scan to their plain versions
    on the card (for the parity prefill only) by swapping
    ops.flash_attention and ops.slstm_scan."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self.ops = ops
        self.kernels = ops.flash_attention, ops.slstm_scan
        ops.flash_attention = lambda q, k, v, *, window=-1: \
            ref.flash_attention(q, k, v, window)
        ops.slstm_scan = ref.slstm_scan

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.slstm_scan = self.kernels


# The kernels' float32 prefill against the plain versions' float32 prefill:
# a fixed bar on the logits (max |x| ≈ 3-13 at these archs), 8× the largest
# difference seen (zamba2-2.7b, 1.2e-4).  A MoE arch's top-k routing could
# turn a 1e-6 difference into another expert; with these seeds none does.
F32_PARITY_TOL = 1e-3


def _top1_agree(torch, what: str, a, b, tol: float) -> None:
    """Top-1 equal in every row, or a gap within ``tol`` between the two
    picks."""
    top_a, top_b = a.argmax(-1), b.argmax(-1)
    for r in range(a.shape[0]):
        i, j = int(top_a[r]), int(top_b[r])
        if i != j:
            gap = max(abs(float(a[r, i] - a[r, j])), abs(float(b[r, i] - b[r, j])))
            log(f"  {what} row {r}: top-1 {i} vs {j}, logit gap {gap:.4g}")
            require(gap <= tol, f"{what} row {r}: top-1 differs by a gap "
                    f"{gap} > {tol}")
    log(f"  {what}: top-1 equal in {int((top_a == top_b).sum())} of "
        f"{a.shape[0]} rows")


def prefill_parity(torch, cfg, prefill, params, tokens, fe, logits) -> dict:
    """The same prefill with the plain attention and sLSTM scan against
    the kernels' ``logits``, within twice the bf16 path's own rounding
    error (bf16 vs float32 compute, kernel path), top-1 included; then
    both paths in float32 compute, within F32_PARITY_TOL, top-1 included.
    Returns the kernel launches of the float32 prefill."""
    from repro_torch.kernels import ops
    from repro_torch.serve.lm import make_prefill_fn

    prefill32 = make_prefill_fn(cfg, compute_dtype=torch.float32)
    with plain_kernels():
        ops.reset_counts()
        plain_logits = prefill(params, tokens, fe)
        plain32 = prefill32(params, tokens, fe)
        require(not any(ops.LAUNCHES.values()),
                "the parity prefills launched a kernel")
    ops.reset_counts()
    ref32 = prefill32(params, tokens, fe)
    launches = dict(ops.LAUNCHES)
    a, b = logits.float(), plain_logits.float()
    diff = float((a - b).abs().max())
    noise = float((a - ref32).abs().max())
    tol = 2 * noise
    log(f"  parity: kernels vs plain versions (bf16 path) max abs logit diff "
        f"{diff:.4g}; bf16 vs float32 compute (kernel) {noise:.4g}; "
        f"tolerance 2 × that = {tol:.4g}; logits max |x| "
        f"{float(a.abs().max()):.4g}")
    require(diff <= tol, f"kernel vs plain prefill logits differ by {diff} "
            f"> {tol}")
    _top1_agree(torch, "bf16 path", a, b, tol)
    diff32 = float((ref32 - plain32).abs().max())
    log(f"  parity in float32 compute: kernels vs plain versions max abs "
        f"logit diff {diff32:.4g} (tolerance {F32_PARITY_TOL})")
    require(diff32 <= F32_PARITY_TOL, f"float32 kernel vs plain prefill "
            f"logits differ by {diff32} > {F32_PARITY_TOL}")
    _top1_agree(torch, "float32 path", ref32, plain32, F32_PARITY_TOL)
    return launches


def lm_main_phase(torch, seed: int, batch: int, seq: int):
    """gemma3-1b at full width: prefill (the kernel's path) and decode."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.lm import ServeLoop, make_prefill_fn

    cfg = gemma3_1b.config()
    t0 = phase(f"lm main path: {cfg.name} prefill B {batch} S {seq} + decode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in params.values() if torch.is_tensor(t))
    n_params += sum(t.numel() for lp in params["layers"] for t in lp.values())
    require(n_params == cfg.n_params() == 999_812_736,
            f"gemma3-1b has {n_params} parameters")
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    prefill = make_prefill_fn(cfg)
    torch.cuda.synchronize()
    ops.reset_counts()
    t = time.perf_counter()
    logits = prefill(params, tokens)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    log(f"  kernel launches {launches}; plain calls {plain}")
    require(launches["flash_attention"] == cfg.n_layers == 26,
            f"prefill launched flash_attention "
            f"{launches['flash_attention']} times, not once per layer")
    require(all(n == 0 for n in plain.values()),
            f"a plain version ran on the prefill: {plain}")
    require(logits.shape == (batch, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"prefill logits malformed: {tuple(logits.shape)}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(params, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    pre_s = statistics.median(times)
    peak_prefill = torch.cuda.max_memory_allocated()
    log(f"  prefill: {pre_s * 1e3:.1f} ms median of 3 (first call "
        f"{cold_s * 1e3:.1f} ms), {batch * seq / pre_s:.0f} tokens/s; peak "
        f"device memory {peak_prefill / 2**30:.2f} GiB (parameters "
        f"{n_params * 4 / 2**30:.2f} GiB fp32)")

    log_breakdown("prefill under the profiler",
                  *device_breakdown(torch, lambda: prefill(params, tokens)))
    run_launches = ops.LAUNCHES["flash_attention"]

    run_launches += prefill_parity(torch, cfg, prefill, params, tokens,
                                   None, logits)["flash_attention"]
    del logits

    # Decode: teacher-forced prompt then greedy tokens, through the cache.
    loop = ServeLoop(cfg, params, max_len=64)
    prompts = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev,
                            dtype=torch.int32)
    steps = 32 + 32 - 1
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = loop.generate(prompts, n_new=32)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    require(out.shape == (4, 64) and torch.equal(out[:, :32], prompts)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            "generate output malformed")
    log_breakdown("7 decode steps under the profiler", *device_breakdown(
        torch, lambda: loop.generate(prompts[:, :4], n_new=4)))
    peak = torch.cuda.max_memory_allocated()
    log(f"  decode: B 4, {steps} steps: {runs[1] / steps * 1e3:.2f} ms per "
        f"step (first run {runs[0] / steps * 1e3:.2f} ms); new tokens of "
        f"row 0: {out[0, 32:].tolist()}")
    log(f"  peak device memory over the phase: {peak / 2**30:.2f} GiB")
    del params, loop
    torch.cuda.empty_cache()
    log(f"  flash_attention launches over the phase's {run_launches // 26}"
        f" kernel prefills: {run_launches}")
    log(f"lm main path done in {time.perf_counter() - t0:.1f} s")
    return launches["flash_attention"], run_launches


# The attention family at full width on the card (after gemma3-1b, phase
# 15): (arch, layers kept, None for the full depth; new tokens of the
# greedy run; profiled: the prefill timed as a median of 3, both profiles,
# two greedy runs).  The depth of the archs that do not fit is cut to what
# one 80 GB card holds beside the parity prefills; widths are never cut.
LM_FAMILY = (("granite-moe-3b-a800m", None, 32, True),
             ("gemma-2b", None, 16, False),
             ("musicgen-large", None, 16, False),
             ("qwen2.5-32b", 4, 16, False),
             ("qwen1.5-32b", 4, 16, False),
             ("chameleon-34b", 4, 16, False),
             ("mixtral-8x22b", 2, 16, False))
# The SSM archs at full width and depth (phase 16), in LM_FAMILY's format.
LM_SSM = (("zamba2-2.7b", None, 32, True),
          ("xlstm-125m", None, 32, True))
# The arch whose greedy run is repeated with the int8 KV cache.
INT8_ARCH = "granite-moe-3b-a800m"

# Functions wrapped in record_function ranges for the profiled runs only:
# name -> (module under repro_torch.models, the group of the kernels its
# matmul ops launch, the group of its other ops' kernels (None: grouped
# as outside any range)).  The MoE's three steps (models/layers.py) and
# the SSMs' chunked recurrence (models/ssm.py).
SPANS = {"_moe_dispatch": ("layers", "moe dispatch/combine",
                           "moe dispatch/combine"),
         "_moe_combine": ("layers", "moe dispatch/combine",
                          "moe dispatch/combine"),
         "_moe_experts": ("layers", "moe expert products", None),
         "_chunked_glr": ("ssm", "recurrence products",
                          "recurrence elementwise")}
# Kernels launched through ctypes (no op owns them), grouped by name.
CTYPES_KERNELS = {"flash_kernel": "flash_attention",
                  "slstm_scan_kernel": "slstm_scan",
                  "slstm_walk_kernel": "slstm_scan",
                  "flash_bwd_": "flash_attention_bwd",
                  "slstm_bwd_": "slstm_scan_bwd",
                  "slstm_states_kernel": "slstm_scan_bwd"}
MATMUL_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
              "aten::matmul", "aten::linear", "aten::einsum"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::to", "aten::clone",
            "aten::contiguous"}


class profile_spans:
    """Wraps the functions of SPANS in ``record_function`` ranges, for the
    profiled runs only."""

    def __enter__(self):
        import importlib

        import torch

        self.saved = []
        for n, (mod, _, _) in SPANS.items():
            m = importlib.import_module(f"repro_torch.models.{mod}")
            f = getattr(m, n)
            self.saved.append((m, n, f))

            def wrapped(*a, _f=f, _n=n):
                with torch.profiler.record_function(_n):
                    return _f(*a)
            setattr(m, n, wrapped)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _ctypes_group(name: str):
    return next((g for k, g in CTYPES_KERNELS.items() if k in name.lower()),
                None)


def device_groups(torch, fn):
    """(wall s, {group: device ms}, kernels, top) of one call of ``fn``
    under torch.profiler, each kernel grouped by the op that launched it:
    the attention and sLSTM kernels; the MoE's routing, dispatch and
    combine; its expert products (the float32 bmm's); the chunked
    recurrence's products and its elementwise passes; other matmuls
    (projections, the MLP, the head, the decode attention's einsums);
    casts and copies (the fp32 -> bf16 weight casts, mostly); the rest.  A
    kernel no op claims counts under "unattributed"; groups with no
    kernel are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile_spans(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    groups = dict.fromkeys((*CTYPES_KERNELS.values(),
                            *(g for _, *gs in SPANS.values() for g in gs if g),
                            "matmuls", "casts and copies", "other"), 0.0)
    by_name: dict = {}
    device_ms, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name in SPANS:          # a range's own span on the device
                continue
            ms = e.time_range.elapsed_us() / 1e3
            device_ms += ms
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            if _ctypes_group(e.name):
                groups[_ctypes_group(e.name)] += ms
            continue
        span = e
        while span is not None and span.name not in SPANS:
            span = span.cpu_parent
        span = None if span is None else SPANS[span.name]
        for kern in getattr(e, "kernels", ()):
            ms = kern.duration / 1e3
            if _ctypes_group(kern.name):
                continue
            key = None
            if span is not None:
                key = span[1] if e.name in MATMUL_OPS else span[2]
            if key is None:
                key = ("matmuls" if e.name in MATMUL_OPS else
                       "casts and copies" if e.name in COPY_OPS else "other")
            groups[key] += ms
    groups = {k: v for k, v in groups.items() if v > 0}
    groups["unattributed"] = max(0.0, device_ms - sum(groups.values()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall, groups, n, top


def unique_numel(tree) -> int:
    """Elements of the distinct tensors of a parameter tree (zamba2's
    shared block counts once, as in ``cfg.n_params()``)."""
    seen, stack = {}, [tree]
    while stack:
        node = stack.pop()
        if hasattr(node, "numel"):
            seen[id(node)] = node.numel()
        else:
            stack.extend(node.values() if isinstance(node, dict) else node)
    return sum(seen.values())


def lm_family_arch(torch, arch: str, layers, n_new: int, profiled: bool,
                   seed: int, batch: int, seq: int) -> tuple[dict, int]:
    """One arch at full width on the card, seeded weights, bf16 compute:
    the prefill (its kernel launches by kind, no plain call, finite
    logits, parity with the plain kernels) and a greedy decode (one
    slstm_scan launch per sLSTM layer a step, no plain call); profiled
    archs also get a median of 3 prefills, both profiles and a second
    greedy run, INT8_ARCH the int8 cache.  Returns (the first prefill's
    kernel launches, the flash_attention launches of every prefill of the
    arch)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import FRONTEND_LEN
    from repro_torch.models.config import Segment
    from repro_torch.models.transformer import init_params, layer_specs
    from repro_torch.serve.lm import ServeLoop, make_prefill_fn

    t0 = time.perf_counter()
    cfg = registry.get_config(arch)
    full_layers = cfg.n_layers
    if layers is not None:
        (seg,) = cfg.segments
        cfg = dataclasses.replace(cfg, segments=(
            Segment(reps=layers // len(seg.layers), layers=seg.layers),))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, gen, device=dev)
    n_params = unique_numel(params)
    require(n_params == cfg.n_params(),
            f"{arch}: {n_params} parameters, the config says {cfg.n_params()}")
    kinds = [spec.kind for spec in layer_specs(cfg)]
    shared = sum(lp is params.get("shared") for lp in params["layers"])
    window = max(spec.window for spec in layer_specs(cfg))
    s_fe = FRONTEND_LEN.get(arch, 0)
    log(f"  {arch}: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"of {cfg.hd}, {cfg.n_layers} of {full_layers} layers ("
        f"{', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))})"
        f"{f', one shared block for {shared} invocations' if shared else ''}"
        f"{f', {cfg.n_experts} experts top {cfg.top_k}' if cfg.n_experts else ''}"
        f"{f', window {window}' if window > 0 else ''}"
        f"{f', ssm_state {cfg.ssm_state}' if 'mamba2' in kinds else ''}"
        f"{f', chunk {cfg.ssm_chunk}' if {'mamba2', 'mlstm'} & set(kinds) else ''}"
        f"{f', frontend {s_fe} positions' if s_fe else ''}: {n_params:,} "
        f"parameters ({n_params * 4 / 1e9:.2f} GB fp32), "
        f"{cfg.n_active_params():,} active")
    want = kind_counts(cfg)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    fe = (torch.randn((batch, s_fe, cfg.d_model), generator=gen, device=dev)
          if s_fe else None)
    prefill = make_prefill_fn(cfg)
    torch.cuda.synchronize()
    ops.reset_counts()
    t = time.perf_counter()
    logits = prefill(params, tokens, fe)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    got = {k: launches[k] for k in want}
    require(got == want and sum(launches.values()) == sum(want.values()),
            f"{arch}: prefill kernel launches {launches}, expected {want}")
    require(not any(plain.values()),
            f"{arch}: a plain version ran on the prefill: {plain}")
    require(logits.shape == (batch, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"{arch}: prefill logits malformed: {tuple(logits.shape)}")
    times = []
    for _ in range(3 if profiled else 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(params, tokens, fe)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    pre_s = statistics.median(times)
    log(f"  prefill B {batch} S {seq}: {pre_s * 1e3:.1f} ms "
        f"{'median of 3' if profiled else 'warm'} (first call "
        f"{cold_s * 1e3:.1f} ms), {batch * seq / pre_s:.0f} tokens/s, "
        f"launches { {k: v for k, v in got.items() if v} }, no plain call; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profiled:
        log_breakdown("prefill under the profiler", *device_groups(
            torch, lambda: prefill(params, tokens, fe)))
    run_launches = ops.LAUNCHES["flash_attention"]
    run_launches += prefill_parity(torch, cfg, prefill, params, tokens, fe,
                                   logits)["flash_attention"]
    del logits
    torch.cuda.empty_cache()

    loop = ServeLoop(cfg, params, max_len=64)
    prompts = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev,
                            dtype=torch.int32)
    steps = 32 + n_new - 1
    runs = []
    for _ in range(2 if profiled else 1):
        torch.cuda.synchronize()
        ops.reset_counts()
        t = time.perf_counter()
        out = loop.generate(prompts, n_new=n_new)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    require(out.shape == (4, 32 + n_new) and torch.equal(out[:, :32], prompts)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"{arch}: generate output malformed")
    require(ops.LAUNCHES["slstm_scan"] == steps * want["slstm_scan"]
            and not any(ops.PLAIN.values()),
            f"{arch}: decode launched slstm_scan {ops.LAUNCHES['slstm_scan']}"
            f" times, plain calls {ops.PLAIN}")
    n_scan = ops.LAUNCHES["slstm_scan"]
    log(f"  decode: B 4, {steps} steps: {runs[-1] / steps * 1e3:.2f} ms per "
        f"step{f' (first run {runs[0] / steps * 1e3:.2f} ms)' if profiled else ''}"
        f", {4 * steps / runs[-1]:.0f} tokens/s"
        f"{f', slstm_scan launches {n_scan}' if n_scan else ''}"
        f"; new tokens of row 0: {out[0, 32:].tolist()}")
    if arch == INT8_ARCH:
        loop8 = ServeLoop(dataclasses.replace(cfg, kv_dtype="int8"), params,
                          max_len=64)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out8 = loop8.generate(prompts, n_new=n_new)
        torch.cuda.synchronize()
        t8 = time.perf_counter() - t
        require(out8.shape == out.shape and torch.equal(out8[:, :32], prompts),
                f"{arch}: int8 generate output malformed")
        same = float((out8[:, 32:] == out[:, 32:]).float().mean())
        log(f"  int8 KV cache: {t8 / steps * 1e3:.2f} ms per step; "
            f"{same:.1%} of the {4 * n_new} greedy tokens equal the bf16 "
            f"cache's; new tokens of row 0: {out8[0, 32:].tolist()}")
        del loop8
    if profiled:
        log_breakdown("7 decode steps under the profiler", *device_groups(
            torch, lambda: loop.generate(prompts[:, :4], n_new=4)))
    log(f"  {arch} done in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, loop
    torch.cuda.empty_cache()
    return launches, run_launches


def lm_family_phase(torch, title: str, entries, seed: int, batch: int,
                    seq: int) -> tuple[dict, int]:
    """The archs of ``entries`` (LM_FAMILY's format) one after the other,
    each freed before the next.  Returns (the first prefills' kernel
    launches summed, every flash_attention launch of the phase)."""
    t0 = phase(f"{title}: {', '.join(e[0] for e in entries)} at full width, "
               f"prefill B {batch} S {seq} + decode")
    first, total = {}, 0
    for arch, layers, n_new, profiled in entries:
        got, run = lm_family_arch(torch, arch, layers, n_new, profiled, seed,
                                  batch, seq)
        for k, v in got.items():
            first[k] = first.get(k, 0) + v
        total += run
    log(f"{title} done in {time.perf_counter() - t0:.1f} s; first prefills' "
        f"launches { {k: v for k, v in first.items() if v} }; "
        f"flash_attention launches in all {total}")
    return first, total


# ---------------------------------------------------------------------------
# Training (phase 17): the two backward kernels alone, one train step of
# every smoke config kernels against plain, then launch/train.py at full
# width.
# ---------------------------------------------------------------------------

# (what, BH, Sq, Sk, hd, window): gemma3-1b's shapes at both windows, the
# hd-80 heads (zamba2's width, padded to 128) and a ragged shape whose rows
# 183-199 see no key.  The hd-80 BH is --lm-batch × 32.
FLASH_BWD_CASES = (("gemma3-1b window 512", 8, 4096, 4096, 256, 512),
                   ("gemma3-1b full causal", 8, 4096, 4096, 256, -1),
                   ("hd 80 padded to 128", None, 4096, 4096, 80, -1),
                   ("(3, 200, 136, 64) window 48", 3, 200, 136, 64, 48))
# A gradient's max abs error against float64 autograd through the plain
# version: at most this many times the plain float32 gradient's own, and at
# most FLASH_BWD_REL of the gradient's largest magnitude.
FLASH_BWD_TIMES = 2.0
FLASH_BWD_REL = 1e-4


# Padded head dims at or below this run the backward's products as fp32
# fused multiply-adds on the CUDA cores (csrc/flash_attention_bwd.cu:
# kFma); wider ones as split-TF32 mma.sync on the tensor cores.
FLASH_BWD_FMA_HD = 32


def flash_bwd_work(bh: int, sq: int, sk: int, hd: int, window: int):
    """(bound, fp32 bound, live pairs) of one backward: 10·hd operations a
    live pair (scores and dP again, dv, dk, dq) against q, k, v, dO, lse
    read once and dq, dk, dv written once.  ``bound`` is that of the
    arithmetic the kernel runs at hd, as ``flash_case``'s is of the
    forward's: TF32_PASSES TF32 products an operation on the tensor cores,
    or fp32 on the CUDA cores where the padded hd is at most
    FLASH_BWD_FMA_HD.  The fp32 bound is given beside it."""
    from repro_torch.kernels import flash_attention as kern

    pairs = bh * sum(min(i + 1, sk, window) if window >= 0 else min(i + 1, sk)
                     for i in range(sq))
    n_bytes = 4 * bh * (4 * sq * hd + 3 * sk * hd + sq)
    fp32 = bound_ms(n_bytes, 10 * hd * pairs)
    if kern.padded_head_dim(hd) <= FLASH_BWD_FMA_HD:
        return fp32, fp32, pairs
    return (bound_ms(n_bytes, TF32_PASSES * 10 * hd * pairs,
                     peaks().tf32_flops), fp32, pairs)


def _plain_attention_grads(torch, q, k, v, do, window: int, dtype,
                           chunk: int = 4):
    """Autograd through the plain flash_attention in ``dtype``, a few rows
    of BH at a time (the (S, S) scores of all rows at once would not fit
    in float64)."""
    from repro_torch.kernels import ref

    grads = [torch.empty(t.shape, dtype=dtype, device=t.device)
             for t in (q, k, v)]
    for s in range(0, q.shape[0], chunk):
        e = min(s + chunk, q.shape[0])
        xs = [t[s:e].to(dtype).requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention(*xs, window)
        for g, x in zip(grads, torch.autograd.grad(out, xs, do[s:e].to(dtype))):
            g[s:e] = x
    return grads


def flash_bwd_case(torch, what, bh, sq, sk, hd, window, gen, timed: bool):
    """The backward through ``ops.flash_attention``'s autograd Function
    against float64 and float32 autograd through the plain version; two
    runs bit for bit; times when ``timed``."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kern
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    q, k, v = (torch.randn((bh, n, hd), generator=gen, device=dev)
               for n in (sq, sk, sk))
    do = torch.randn((bh, sq, hd), generator=gen, device=dev)

    def kernel_grads():
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*xs, window=window)
        return torch.autograd.grad(out, xs, do)

    ops.reset_counts()
    got = kernel_grads()
    torch.cuda.synchronize()
    counts = (ops.LAUNCHES["flash_attention"],
              ops.LAUNCHES["flash_attention_bwd"], sum(ops.PLAIN.values()))
    require(counts == (1, 1, 0), f"flash_attention_bwd {what}: launches "
            f"(forward, backward, plain) {counts}, expected (1, 1, 0)")
    again = kernel_grads()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    require(same, f"flash_attention_bwd {what}: two runs differ")
    del again
    want64 = _plain_attention_grads(torch, q, k, v, do, window, torch.float64)
    want32 = _plain_attention_grads(torch, q, k, v, do, window, torch.float32)
    errs = {}
    for name, g, w64, w32 in zip(("dq", "dk", "dv"), got, want64, want32):
        require(bool(torch.isfinite(g).all()),
                f"flash_attention_bwd {what}: {name} not finite")
        err = max_err(torch, g, w64)
        plain_err = max_err(torch, w32, w64)
        top = float(w64.abs().max())
        errs[name] = (err, plain_err, top)
        require(err <= FLASH_BWD_TIMES * plain_err
                and err <= FLASH_BWD_REL * top,
                f"flash_attention_bwd {what}: {name} max abs err {err:.3g} "
                f"against float64; the plain float32 one {plain_err:.3g}; "
                f"largest |{name}| {top:.3g}")
    if sq > sk + max(window, 0) - 1 and window >= 0:
        dead = sk + window - 1
        require(bool((got[0][:, dead:] == 0).all()),
                f"flash_attention_bwd {what}: dq of rows with no live key "
                f"is not 0")
    log(f"  flash_attention_bwd {what} (BH {bh}, Sq {sq}, Sk {sk}, hd {hd}, "
        f"window {window}): max abs err against float64 autograd "
        + "; ".join(f"{n} {e:.3g} (plain float32 {p:.3g}, largest {t:.3g})"
                    for n, (e, p, t) in errs.items())
        + "; two runs bit for bit")
    del want64, want32, got
    rec = dict(max_abs_err=max(e for e, _, _ in errs.values()),
               err_ratio=max(e / max(p, 1e-30) for e, p, _ in errs.values()),
               rel_err=max(e / max(t, 1e-30) for e, _, t in errs.values()))
    if not timed:
        return rec
    # The backward's launches alone, on the forward's saved tensors.
    hp = kern.padded_head_dim(hd)
    qp, kp, vp, dop = (F.pad(t, (0, hp - hd)) for t in (q, k, v, do))
    o = torch.empty((bh, sq, hp), device=dev)
    lse = torch.empty((bh, sq), device=dev)
    scale = 1.0 / math.sqrt(hd)
    kern.launch(qp, kp, vp, window, sk, o, scale, lse)
    # The forward with and without the lse output, in turns.
    fwd = {False: [], True: []}
    for with_lse in (False, True, True, False):
        fwd[with_lse].append(time_ms(torch, lambda: kern.launch(
            qp, kp, vp, window, sk, o, scale, lse if with_lse else None)))
    dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
    scratch = kern.bwd_scratch(bh, sq, sk, window, dev)
    ms = time_ms(torch, lambda: kern.launch_bwd(
        qp, kp, vp, lse, dop, window, sk, scale, dq, dk, dv, scratch))
    del o
    plain_ms = time_ms(torch, lambda: ref.flash_attention_bwd(
        q, k, v, lse, do, window), reps=3)
    # scaled_dot_product_attention's float32 backward on the same inputs.
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    if window < 0:
        lib_out = F.scaled_dot_product_attention(*xs, is_causal=True)
    else:
        lib_out = F.scaled_dot_product_attention(
            *xs, attn_mask=ref.band_mask(sq, sk, window, sk, dev))
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, xs, do, retain_graph=True), reps=3)
    del xs, lib_out
    bound, fp32_bound, pairs = flash_bwd_work(bh, sq, sk, hd, window)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound=bound,
               fp32_bound_ms=fp32_bound[0], live_pairs=pairs,
               forward_ms=fwd[False], forward_lse_ms=fwd[True])
    how = (f"{TF32_PASSES} TF32 passes on the tensor cores"
           if bound is not fp32_bound else "fp32 on the CUDA cores")
    log(f"    {ms:.3f} ms (plain {plain_ms:.3f} ms, sdpa float32 backward "
        f"{library_ms:.3f} ms); bound {bound[0]:.4f} ms by {bound[1]} in "
        f"{how} ({bound[0] / ms:.1%} of it), {fp32_bound[0]:.4f} ms in "
        f"fp32 on the CUDA cores ({fp32_bound[0] / ms:.1%} of it); "
        f"{pairs} live pairs; scratch "
        f"{scratch.numel() * 4 / 2**30:.3f} GiB; the forward without lse "
        f"{fwd[False]} ms, with it {fwd[True]} ms (in turns)")
    return rec


def log_bwd_resources() -> dict:
    """Registers, spills and shared memory of the backward kernels
    (ptxas); fails on a spill."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kern

    out = {}
    for name in ("flash_attention_bwd", "slstm_scan_bwd"):
        for r in _build.ptxas_report(name):
            m = re.search(r"ILi(\d+)E", r["kernel"])
            launch = [n for n in kern.BWD_KERNELS if n in r["kernel"]]
            extra = ""
            if name == "flash_attention_bwd" and launch:
                smem, blocks = kern.bwd_resources(int(m.group(1)))[launch[0]]
                extra = f"; {smem} B shared memory, {blocks} block(s) an SM"
            log(f"  {r['kernel']}: {r['registers']} registers, spill stores "
                f"{r['spill_stores']} B, loads {r['spill_loads']} B{extra}")
            require(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                    f"{r['kernel']} spills")
            out[r["kernel"]] = r
    return out


def flash_bwd_rows(torch, seed: int, batch: int) -> dict:
    """flash_attention_bwd at FLASH_BWD_CASES; the row of the kernels line
    is gemma3-1b's full causal case."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 27)
    row, by_case = None, {}
    for what, bh, sq, sk, hd, window in FLASH_BWD_CASES:
        bh = bh or batch * 32
        rec = flash_bwd_case(torch, what, bh, sq, sk, hd, window, gen,
                             timed=sq == sk)
        torch.cuda.empty_cache()
        by_case[f"{bh}x{sq}x{sk}x{hd} window {window}"] = {
            k: (v[0] if k == "bound" else v) for k, v in rec.items()}
        if what == "gemma3-1b full causal":
            row = rec
    row = dict(row)
    row["max_abs_err"] = max(r["max_abs_err"] for r in by_case.values())
    row["extra"] = dict(fp32_bound_ms=row.pop("fp32_bound_ms"),
                        err_over_plain=max(r["err_ratio"]
                                           for r in by_case.values()),
                        by_case=by_case)
    return row


# (what, B, S, D, cached state): xlstm-125m's prefill widths from the zero
# state, a decode-sized step from a cached one.
SLSTM_BWD_CASES = (("xlstm-125m prefill", 2, 4096, 768, False),
                   ("S 1", 4, 1, 768, True),
                   ("D not a multiple of 32", 3, 200, 100, True))


def slstm_bwd_cases(tile: int, walk: int) -> tuple:
    """SLSTM_BWD_CASES and the backward's edges for its tiles of ``tile``
    steps and its walk below ``walk`` steps: the walk's last S, and an S
    that is no multiple of the tile."""
    return SLSTM_BWD_CASES + (
        ("S = W - 1, the walk's last", 4, walk - 1, 768, True),
        ("S = 3T + 5, no multiple of the tile", 2, 3 * tile + 5, 768, True))


def launch_device_ms(torch, fn, names, calls: int = 5) -> dict | None:
    """{name: mean device ms a launch} of the kernels whose names contain
    each of ``names``, from ``calls`` calls of ``fn`` in one torch.profiler
    run (after a warm-up call).  A profile can miss launches: up to three
    runs until every name shows, else None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms, seen = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for name in names:
                if name in e.name:
                    ms[name] += e.time_range.elapsed_us() / 1e3
                    seen[name] += 1
        if all(seen.values()):
            return {name: ms[name] / seen[name] for name in names}
    return None


def slstm_adjoint_floor(torch, seed: int, b: int, s: int, d: int) -> dict:
    """The adjoint chains' floor at (b, s, d): chain A's gc, gn and chain
    B's gm alone from registers (``scripts/slstm_floor.cu``, built here),
    b·d / 32 warps over s steps."""
    from scripts.sketch_sim_probe import compile_all
    from scripts.slstm_probe import FLOOR_SOURCE, adjoint_floor_ms

    lib = compile_all([FLOOR_SOURCE])[FLOOR_SOURCE]
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    return adjoint_floor_ms(torch, lib, b * d // 32, s, gen)


def slstm_bwd_rows(torch, seed: int) -> dict:
    """slstm_scan_bwd through ``ops.slstm_scan``'s autograd Function
    against the plain reverse loop, bit for bit, and S/2 + S/2 with the
    state's adjoints carried against one launch; its time beside the
    plain loop's and the bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import slstm_scan as kern

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 28)
    row = None
    for what, b, s, d, cached in slstm_bwd_cases(kern.BWD_TILE,
                                                 kern.BWD_WALK_BELOW):
        gates = torch.randn((b, s, 4 * d), generator=gen, device=dev)
        state = slstm_state(torch, b, d, gen, cached)
        adj = (torch.randn((b, s, d), generator=gen, device=dev),
               *(torch.randn((b, d), generator=gen, device=dev)
                 for _ in range(3)))
        xs = [t.clone().requires_grad_() for t in (gates, *state)]
        ops.reset_counts()
        got = torch.autograd.grad(ops.slstm_scan(*xs), xs, adj)
        counts = (ops.LAUNCHES["slstm_scan"], ops.LAUNCHES["slstm_scan_bwd"],
                  sum(ops.PLAIN.values()))
        require(counts == (1, 1, 0), f"slstm_scan_bwd {what}: launches "
                f"(forward, backward, plain) {counts}, expected (1, 1, 0)")
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = ref.slstm_scan_bwd(gates, *state, *adj)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        err, same = 0.0, True
        for name, g, w in zip(("dgates", "dc0", "dn0", "dm0"), got, want):
            require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                    f"slstm_scan_bwd {what}: {name} malformed")
            same = same and torch.equal(g, w)
            err = max(err, max_err(torch, g, w) / max(float(w.abs().max()),
                                                      1e-30))
        require(same or err <= 1e-6, f"slstm_scan_bwd {what}: max error "
                f"{err:.3g} of the largest gradient (bound 1e-6)")
        again = torch.autograd.grad(ops.slstm_scan(*xs), xs, adj)
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"slstm_scan_bwd {what}: two runs differ")
        carried = ""
        if s > 1:
            h = s // 2

            def kernel_bwd(gp, st, a):
                dg = torch.empty_like(gp)
                d0 = [torch.empty_like(x) for x in st]
                kern.launch_bwd(gp, *st, *(x.contiguous() for x in a),
                                torch.empty((3, b, gp.shape[1], d),
                                            device=dev), dg, *d0)
                return (dg, *d0)

            g1, g2 = gates[:, :h].contiguous(), gates[:, h:].contiguous()
            mid = ops.slstm_scan(g1, *state)[1:]
            second = kernel_bwd(g2, mid, (adj[0][:, h:], *adj[1:]))
            first = kernel_bwd(g1, state, (adj[0][:, :h], *second[1:]))
            chained = (torch.cat([first[0], second[0]], dim=1), *first[1:])
            require(all(torch.equal(a, w) for a, w in zip(chained, got)),
                    f"slstm_scan_bwd {what}: S/2 + S/2 with the adjoints "
                    f"carried differs from one launch over S")
            carried = "; S/2 + S/2 with the adjoints carried equals one launch"
        log(f"  slstm_scan_bwd {what} (B {b}, S {s}, D {d}): "
            f"{'bit for bit' if same else f'max err {err:.3g} of the largest'}"
            f" against the plain reverse loop, two runs the same{carried}; "
            f"{kern.bwd_blocks(b, d, s)} blocks "
            f"({'walk' if s < kern.BWD_WALK_BELOW else 'tiles'})")
        if what == "xlstm-125m prefill":
            states = torch.empty((3, b, s, d), device=dev)
            outs = [torch.empty_like(t) for t in (gates, *state)]
            args = [gates, *state, *adj, states, *outs]
            ms = time_ms(torch, lambda: kern.launch_bwd(*args))
            n_bytes = 4 * b * s * (4 * d + d + 4 * d) + 4 * 10 * b * d
            # some 45 float operations a channel a step: the forward again
            # (12) and the adjoints (33)
            bound = bound_ms(n_bytes, 45 * b * s * d)
            names = ("slstm_states_kernel", "slstm_bwd_tiles_kernel")
            split = launch_device_ms(torch, lambda: kern.launch_bwd(*args),
                                     names) or dict.fromkeys(names)
            smem, per_sm = kern.bwd_resources()
            floor = slstm_adjoint_floor(torch, seed, b, s, d)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
                       library_ms=None, bound=bound,
                       extra=dict(bitwise=same, dependent_steps=2 * s,
                                  ns_per_step=ms * 1e6 / (2 * s),
                                  scratch_bytes=12 * b * s * d,
                                  forward_again_ms=split[
                                      "slstm_states_kernel"],
                                  adjoints_ms=split["slstm_bwd_tiles_kernel"],
                                  blocks=kern.bwd_blocks(b, d, s),
                                  warps=kern.BWD_WARPS, tile=kern.BWD_TILE,
                                  smem_bytes=smem, blocks_per_sm=per_sm,
                                  walk_below=kern.BWD_WALK_BELOW,
                                  adjoint_floor_ns_per_step={
                                      "gc_gn": floor["gc_gn"]["ns_per_step"],
                                      "gm": floor["gm"]["ns_per_step"]}))
            log(f"    {ms:.3f} ms, {ms * 1e6 / (2 * s):.1f} ns a step over "
                f"{2 * s} dependent steps; plain reverse loop "
                f"{plain_s * 1e3:.1f} ms; bound {bound[0]:.4f} ms by "
                f"{bound[1]} ({bound[0] / ms:.1%} of it); profiled, a "
                f"launch: the forward again {split['slstm_states_kernel']} "
                f"ms, the adjoints {split['slstm_bwd_tiles_kernel']} ms "
                f"(None: a profile missed it thrice); "
                f"{kern.bwd_blocks(b, d, s)} blocks of {kern.BWD_WARPS} "
                f"warps (two chain warps, {kern.BWD_WARPS - 2} workers) over "
                f"{kern.BWD_CHANNELS} channels, tiles of {kern.BWD_TILE} "
                f"steps, {smem} B of shared memory a block, {per_sm} "
                f"block(s) an SM; scratch {12 * b * s * d} B; the adjoint "
                f"chains' floor (registers only, {floor['groups']} warps "
                f"over {s} steps): gc, gn "
                f"{floor['gc_gn']['ns_per_step']:.2f} ns a step, gm "
                f"{floor['gm']['ns_per_step']:.2f} ns a step")
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["extra"]["bitwise"] = row["extra"]["bitwise"] and same
    return row


def train_kernel_phase(torch, seed: int, batch: int) -> dict:
    """Phase 17 (a): the two backward kernels against their plain
    versions.  Returns the kernels line's rows."""
    t0 = phase("train (a): flash_attention_bwd and slstm_scan_bwd")
    res = log_bwd_resources()
    rows = {"flash_attention_bwd": flash_bwd_rows(torch, seed, batch),
            "slstm_scan_bwd": slstm_bwd_rows(torch, seed)}
    for name, keys in (("flash_attention_bwd", ("flash_bwd_",)),
                       ("slstm_scan_bwd", ("slstm_bwd_",
                                           "slstm_states_kernel"))):
        regs = {k: r["registers"] for k, r in res.items()
                if any(key in k for key in keys)}
        rows[name]["extra"]["registers"] = regs
    log(f"train (a) passed in {time.perf_counter() - t0:.1f} s")
    return rows


def _grad_parity(torch, what, grad_fn, params, batch, want_counts) -> dict:
    """One loss and gradient on the kernels (launch counts held to
    ``want_counts``, no plain call), then with the plain attention and
    sLSTM scan: the loss within 1e-4, every gradient leaf within
    F32_PARITY_TOL of its largest magnitude.  Returns the kernels' launch
    counts and the worst errors."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_leaves

    ops.reset_counts()
    loss, grads = grad_fn(params, *batch)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in want_counts}
    plain = sum(ops.PLAIN.values())
    require(launches == want_counts and plain == 0,
            f"{what}: kernel launches {launches}, expected {want_counts}; "
            f"plain calls {plain}")
    with plain_kernels():
        ops.reset_counts()
        loss_p, grads_p = grad_fn(params, *batch)
        require(not any(ops.LAUNCHES.values()),
                f"{what}: the plain path launched a kernel")
    d_loss = abs(float(loss) - float(loss_p))
    require(bool(torch.isfinite(loss)) and d_loss <= 1e-4,
            f"{what}: loss {float(loss)} against the plain path's "
            f"{float(loss_p)}")
    worst = 0.0
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        require(bool(torch.isfinite(g).all()), f"{what}: a gradient is not "
                f"finite")
        top = float(w.abs().max())
        err = max_err(torch, g, w)
        worst = max(worst, err / top if top else err)
        require(err <= F32_PARITY_TOL * max(top, 1e-30) or err == 0.0,
                f"{what}: a gradient leaf {tuple(g.shape)} differs by "
                f"{err:.3g}, largest magnitude {top:.3g}")
    return dict(launches=launches, loss=float(loss), loss_diff=d_loss,
                grad_rel_err=worst)


def train_counts(cfg, steps: int = 1) -> dict:
    """Kernel launches of ``steps`` train steps with remat: each attention
    layer (or shared_attn invocation) and sLSTM layer runs its forward
    twice (the recompute) and its backward once."""
    n = kind_counts(cfg)
    return {"flash_attention": 2 * steps * n["flash_attention"],
            "flash_attention_bwd": steps * n["flash_attention"],
            "slstm_scan": 2 * steps * n["slstm_scan"],
            "slstm_scan_bwd": steps * n["slstm_scan"]}


def train_small_phase(torch, seed: int) -> None:
    """Phase 17 (b): one loss and gradient of every smoke config in float32
    on the card, kernels against the plain versions, and one train step."""
    from repro_torch.configs import registry
    from repro_torch.models.transformer import init_params, tree_to
    from repro_torch.train import (TrainConfig, adamw_init, make_grad_fn,
                                   make_train_step)

    t0 = phase(f"train (b): the {len(registry.ARCHS)} smoke configs, "
               f"float32, kernels against plain")
    tcfg = TrainConfig(loss_chunk=16, compute_dtype=torch.float32)
    for arch in registry.ARCHS:
        cfg = registry.smoke_config(arch)
        gen = torch.Generator().manual_seed(seed)
        params = tree_to(init_params(cfg, gen, device="cpu"), "cuda")
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                             dtype=torch.int32).cuda()
        fe = (torch.randn((2, 5, cfg.d_model), generator=gen).cuda()
              if cfg.modality != "text" else None)
        batch = (toks, torch.roll(toks, -1, dims=1), fe)
        rec = _grad_parity(torch, f"train small {cfg.name}",
                           make_grad_fn(cfg, tcfg), params, batch,
                           train_counts(cfg))
        _, _, m = make_train_step(cfg, tcfg)(params, adamw_init(params),
                                             *batch)
        require(all(bool(torch.isfinite(m[k])) for k in m),
                f"train small {cfg.name}: step metrics not finite")
        log(f"  {cfg.name}: loss {rec['loss']:.5f} (plain path "
            f"{rec['loss_diff']:.2g} off), gradients within "
            f"{rec['grad_rel_err']:.3g} of each leaf's largest (tolerance "
            f"{F32_PARITY_TOL}); launches "
            f"{ {k: v for k, v in rec['launches'].items() if v} }, plain 0;"
            f" a train step: grad_norm {float(m['grad_norm']):.4g}")
    log(f"train (b) passed in {time.perf_counter() - t0:.1f} s")


def _train_run(torch, arch: str, batch: int, seq: int, steps: int) -> dict:
    """``launch/train.py``'s main on the card: ``steps`` AdamW steps at
    full width, bf16 compute.  Fails on a non-finite loss or gradient
    norm, on a launch count other than remat's, or on a plain call."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher

    cfg = registry.get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t = time.perf_counter()
    run = launcher.main(["--arch", arch, "--steps", str(steps), "--batch",
                         str(batch), "--seq", str(seq)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    want = train_counts(cfg, steps)
    launches = {k: ops.LAUNCHES[k] for k in want}
    plain = dict((k, v) for k, v in ops.PLAIN.items() if v)
    require(launches == want and not plain,
            f"train {arch}: kernel launches {launches}, expected {want}; "
            f"plain calls {plain}")
    hist = run["history"]
    require(len(hist) == steps and all(
        math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
        for h in hist), f"train {arch}: non-finite loss or gradient norm: "
        f"{hist}")
    steady = [h["seconds"] for h in hist[1:]] or [hist[0]["seconds"]]
    step_s = statistics.median(steady)
    n_params = unique_numel(run["params"])
    rec = dict(arch=arch, layers=cfg.n_layers, batch=batch, seq=seq,
               steps=steps, s_per_step=step_s,
               first_step_s=hist[0]["seconds"],
               tokens_per_s=batch * seq / step_s, peak_gib=peak / 2**30,
               params=n_params, launches=launches,
               losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist], wall_s=wall)
    log(f"  {arch} ({cfg.n_layers} layers, {n_params:,} parameters), B "
        f"{batch} × S {seq}, bf16: {steps} steps through launch/train.py in "
        f"{wall:.1f} s; {step_s:.3f} s a step after the first "
        f"({hist[0]['seconds']:.3f} s), {batch * seq / step_s:,.0f} tokens/s; "
        f"peak {peak / 2**30:.2f} GiB (parameters, gradients and moments "
        f"{4 * 4 * n_params / 2**30:.2f} GiB float32); losses "
        f"{[round(x, 4) for x in rec['losses']]}, grad norms "
        f"{[round(x, 4) for x in rec['grad_norms']]}; launches {launches}, "
        f"plain 0")
    del run
    torch.cuda.empty_cache()
    return rec


def train_main_phase(torch, seed: int, batch: int, seq: int) -> dict:
    """Phase 17 (c): gemma3-1b (26 layers) and xlstm-125m at full width
    through launch/train.py, 3 steps each in bf16; then one float32 loss
    and gradient of each, kernels against plain (gemma3-1b cut to its first
    6 layers, one of them global)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models.config import Segment
    from repro_torch.models.transformer import init_params
    from repro_torch.train import TrainConfig, make_grad_fn

    t0 = phase(f"train (c): gemma3-1b and xlstm-125m at full width, B "
               f"{batch} × S {seq}, through launch/train.py")
    runs = {arch: _train_run(torch, arch, batch, seq, 3)
            for arch in ("gemma3-1b", "xlstm-125m")}
    parity = {}
    for arch in ("gemma3-1b", "xlstm-125m"):
        cfg = registry.get_config(arch)
        if arch == "gemma3-1b":
            cfg = dataclasses.replace(cfg, segments=(
                Segment(reps=1, layers=cfg.segments[0].layers),))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, gen, device="cuda")
        toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                             device="cuda", dtype=torch.int32)
        grad_fn = make_grad_fn(cfg, TrainConfig(compute_dtype=torch.float32))
        t = time.perf_counter()
        rec = _grad_parity(torch, f"train {arch} ({cfg.n_layers} layers) "
                           f"float32", grad_fn, params,
                           (toks, torch.roll(toks, -1, dims=1), None),
                           train_counts(cfg))
        parity[arch] = dict(rec, layers=cfg.n_layers)
        log(f"  {arch} ({cfg.n_layers} layers) float32: loss {rec['loss']:.5f}"
            f", kernels against plain {rec['loss_diff']:.2g}; gradients "
            f"within {rec['grad_rel_err']:.3g} of each leaf's largest "
            f"(tolerance {F32_PARITY_TOL}); launches {rec['launches']}; "
            f"{time.perf_counter() - t:.1f} s")
        del params, grad_fn
        torch.cuda.empty_cache()
    log(f"train (c) passed in {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "parity": parity}


# ---------------------------------------------------------------------------
# The mesh runtime: a world of one in this process, then worlds of spawned
# ranks sharing the card (gloo on CUDA tensors: NCCL refuses two ranks on
# one device).
# ---------------------------------------------------------------------------

def column_sums(torch, means_t):
    """(2, K) int64 on the host: per column, the sum of the float32 bit
    patterns and their sum weighted by row index + 1 (both wrapping in
    int64).  Equal sums mean equal columns bit for bit but for a
    collision; a column of one block sums as that column of the whole."""
    from repro_torch.core.meanindex import row_chunks

    d, k = means_t.shape
    out = torch.zeros((2, k), dtype=torch.int64, device=means_t.device)
    for s, e in row_chunks(d, k):
        bits = means_t[s:e].view(torch.int32).long()
        out[0] += bits.sum(dim=0)
        w = torch.arange(s + 1, e + 1, device=means_t.device)[:, None]
        out[1] += (bits * w).sum(dim=0)
    return out.cpu()


def _mesh_rank(store_dir: str, df_path: str, shape, axes, k: int,
               max_iter: int, obj_chunk: int, ref_path):
    """One spawned rank of a mesh world on the card: the kernels phase 2
    built (none compiled again), the esicp mesh fit over the disk store
    and the mesh classify of its rows (counters zeroed before, read
    after), its block's column sums; with ``ref_path`` (the
    world of one's means) also its block's max abs error against them and
    the mesh classify against ``classify_docs`` on the gathered means."""
    import numpy as np
    import torch

    from repro_torch.cluster import classify_docs
    from repro_torch.core.meanindex import build_mean_index, row_chunks
    from repro_torch.distributed.kmeans import (_local_docs, gather_state,
                                                make_assign_fn, mesh_fit)
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sparse.store import DocStore

    rebuilt = sorted(_build.build())      # phase 2 built every source
    mesh = make_mesh(shape, axes, device="cuda")
    store = DocStore.open(store_dir)
    df = np.load(df_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    traj = []
    t0 = time.perf_counter()
    state, hist, _, params = mesh_fit(store, k, mesh, max_iter=max_iter,
                                      obj_chunk=obj_chunk, df=df,
                                      trajectory=traj)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    geo = state.geo
    local = _local_docs(store, geo, mesh.device)
    labels, sims = make_assign_fn(mesh, k=k, obj_chunk=obj_chunk)(
        local, state.means_t)
    torch.cuda.synchronize()
    out = dict(rank=mesh.rank, k0=geo.k0, row0=geo.row0, n_real=geo.n_real,
               history=hist, traj=[t.numpy() for t in traj],
               rho=state.rho_self[:geo.n_real].cpu().numpy(),
               sums=column_sums(torch, state.means_t).numpy(),
               labels=labels.cpu().numpy(), sims=sims.cpu().numpy(),
               fit_s=fit_s, peak=torch.cuda.max_memory_allocated(),
               launches=dict(ops.LAUNCHES), plain=dict(ops.PLAIN),
               rebuilt=rebuilt)
    if ref_path is not None:
        ref = np.load(ref_path, mmap_mode="r")
        err = 0.0
        for s, e in row_chunks(*state.means_t.shape):
            want = torch.from_numpy(np.array(
                ref[s:e, geo.k0:geo.k0 + geo.k_loc])).to(mesh.device)
            err = max(err, float((state.means_t[s:e] - want).abs().max()))
        out["means_err"] = err
        means_t = gather_state(mesh, state)[0]
        del state
        a, s = classify_docs(build_mean_index(means_t, params), local,
                             batch_size=obj_chunk)
        out["classify_equal"] = bool(torch.equal(a, labels)
                                     and torch.equal(s, sims))
    return out


def _mesh_world(torch, shape, store_dir, df_path, k, max_iter, ref_path,
                tmp):
    from repro_torch.launch.mesh import run_local_world

    n = 1
    for s in shape:
        n *= s
    axes = ("data", "model")
    t = time.perf_counter()
    outs = run_local_world(_mesh_rank, n, backend="gloo", threads=2,
                           timeout=MESH_WORLD_TIMEOUT, workdir=tmp,
                           args=(store_dir, df_path, shape, axes, k,
                                 max_iter, BATCH, ref_path))
    wall = time.perf_counter() - t
    for o in outs:
        require(not o["rebuilt"], f"mesh {shape} rank {o['rank']} built "
                f"{o['rebuilt']} again")
        require(all(v == 0 for v in o["plain"].values()),
                f"mesh {shape} rank {o['rank']}: a plain version ran: "
                f"{o['plain']}")
        log(f"  mesh {shape} rank {o['rank']} (rows from {o['row0']}, "
            f"columns from {o['k0']}): fit {o['fit_s']:.2f} s, s per "
            f"iteration {[round(h['elapsed_s'], 3) for h in o['history']]},"
            f" peak {o['peak'] / 2**30:.2f} GiB")
    log(f"  mesh {shape}: {n} ranks, {wall:.1f} s from spawn to the last "
        f"result")
    return outs


def _sum_launches(launches, outs):
    for o in outs:
        for name in launches:
            launches[name] += o["launches"][name]


def _stitch(outs, n_docs: int, field: str, index=None):
    """The rows of the ranks of model index 0 (k0 == 0), by row offset."""
    import numpy as np

    full = None
    for o in outs:
        if o["k0"]:
            continue
        part = o[field] if index is None else o[field][index]
        if full is None:
            full = np.zeros((n_docs,), part.dtype)
        full[o["row0"]:o["row0"] + o["n_real"]] = part
    return full


def mesh_record(torch, model, cls) -> dict:
    """What the mesh phase holds its world of one and (1, 2) to, on the
    host: phase 5's history, trajectory, ρ_self, classify, and its means'
    column sums (:func:`column_sums`)."""
    return dict(history=model.history, traj=model.trajectory,
                rho=model.rho_self.cpu(),
                sums=column_sums(torch, model.index.means_t),
                labels=cls[0].cpu(), sims=cls[1].cpu())


def mesh_phase(torch, docs, df, ref5: dict, max_iter: int, flat_peak: int):
    """The mesh runtime on the card.  (a) A world of one (NCCL, in this
    process) at the NYT widths from phase 5's seed rows: every iteration's
    assignment, ρ_self, the means (column sums), the history and the mesh
    classify equal phase 5's bit for bit, its peak at most phase 5's +
    1 GiB, the path's kernels launched (segment_update with and without
    ``init``), no plain version.  (b) Two spawned ranks at (1, 2), gloo on
    CUDA tensors sharing the card, the corpus from a disk store: equal to
    (a) bit for bit, each rank's peak and seconds printed.  (c) (2, 1)
    and (2, 2) at MESH_SMALL_DOCS documents, K MESH_SMALL_K,
    MESH_SMALL_ITER iterations: assignments
    equal a world of one's, means within 1e-6, the mesh classify equal to
    ``classify_docs`` bit for bit.  Returns the launches summed over the
    worlds' ranks."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.distributed.kmeans import (LAMBDA_SPAN, make_assign_fn,
                                                mesh_fit)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    t0 = phase(f"mesh: mesh_fit k={NYT_K} esicp, a world of one (NCCL), "
               f"(1, 2) on one card (gloo); (2, 1), (2, 2) at "
               f"{MESH_SMALL_DOCS} documents, k={MESH_SMALL_K}")
    launches = dict.fromkeys(PATH_KERNELS["mesh"], 0)
    n = docs.n_docs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            traj = []
            state, hist, _, _ = mesh_fit(docs, NYT_K, mesh,
                                         max_iter=max_iter, obj_chunk=BATCH,
                                         df=df, trajectory=traj)
            labels, sims = make_assign_fn(mesh, k=NYT_K, obj_chunk=BATCH)(
                docs, state.means_t)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            got, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
            log("  world of one: s per iteration "
                f"{[round(h['elapsed_s'], 3) for h in hist]} against phase "
                f"5's {[round(h['elapsed_s'], 3) for h in ref5['history']]}"
                f"; peak {peak / 2**30:.2f} GiB against phase 5's "
                f"{flat_peak / 2**30:.2f}")
            log(f"  world of one: launches {got}")
            # One λ span (a cut run) launches no init.
            need = [name for name in launches
                    if name != "segment_update_init" or n > LAMBDA_SPAN]
            require(all(got[name] > 0 for name in need),
                    f"a kernel of the mesh path never launched: {got}")
            require(all(v == 0 for v in plain.values()),
                    f"a plain version ran on the mesh path: {plain}")
            require(peak <= flat_peak + (1 << 30),
                    f"the world of one's peak {peak} is above phase 5's "
                    f"{flat_peak} + 1 GiB")
            _same_as_phase5(torch, ref5, hist, [t for t in traj],
                            state.rho_self[:n].cpu(),
                            column_sums(torch, state.means_t), labels.cpu(),
                            sims.cpu(), "world of one")
            for name in launches:
                launches[name] += got[name]
            del state, labels, sims
            torch.cuda.empty_cache()

            # (c)'s reference: a world of one at the reduced size.
            small = docs.slice_rows(0, MESH_SMALL_DOCS)
            small_df = small.df
            state, hist1, _, _ = mesh_fit(small, MESH_SMALL_K, mesh,
                                          max_iter=MESH_SMALL_ITER,
                                          obj_chunk=BATCH, df=small_df)
            small_assign = state.assign[:MESH_SMALL_DOCS].cpu().numpy()
            ref_path = os.path.join(tmp, "small_means.npy")
            np.save(ref_path, state.means_t.cpu().numpy())
            del state
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        # (b) two ranks at (1, 2), the corpus from a disk store.
        big_dir, small_dir = (os.path.join(tmp, d) for d in ("big", "small"))
        os.makedirs(big_dir)
        os.makedirs(small_dir)
        write_store(docs.to("cpu"), big_dir)
        np.save(os.path.join(tmp, "df.npy"), df.cpu().numpy())
        outs = _mesh_world(torch, (1, 2), big_dir,
                           os.path.join(tmp, "df.npy"), NYT_K, max_iter,
                           None, tmp)
        _sum_launches(launches, outs)
        for o in outs:
            want = ref5["sums"][:, o["k0"]:o["k0"] + NYT_K // 2]
            _same_as_phase5(torch, ref5, o["history"],
                            [torch.from_numpy(t) for t in o["traj"]],
                            torch.from_numpy(o["rho"]),
                            torch.from_numpy(o["sums"]),
                            torch.from_numpy(o["labels"]),
                            torch.from_numpy(o["sims"]),
                            f"(1, 2) rank {o['rank']}", sums_want=want)
        log("  (1, 2): both ranks equal phase 5's fit bit for bit (every "
            "iteration's assignment, ρ_self, means column sums, history, "
            "mesh classify)")

        # (c) (2, 1) and (2, 2) at the reduced size.
        write_store(small.to("cpu"), small_dir)
        np.save(os.path.join(tmp, "df_small.npy"), small_df.cpu().numpy())
        for shape in ((2, 1), (2, 2)):
            outs = _mesh_world(torch, shape, small_dir,
                               os.path.join(tmp, "df_small.npy"),
                               MESH_SMALL_K, MESH_SMALL_ITER, ref_path, tmp)
            _sum_launches(launches, outs)
            got = _stitch(outs, MESH_SMALL_DOCS, "traj", -1)
            require(np.array_equal(got, small_assign),
                    f"mesh {shape}: assignments differ from the world of "
                    f"one's in {int((got != small_assign).sum())} rows")
            err = max(o["means_err"] for o in outs)
            require(err <= 1e-6, f"mesh {shape}: means {err} from the "
                    f"world of one's")
            require(all(o["classify_equal"] for o in outs),
                    f"mesh {shape}: make_assign_fn differs from "
                    "classify_docs")
            log(f"  mesh {shape}: assignments equal the world of one's, "
                f"means within {err:.3g}, the mesh classify equal to "
                f"classify_docs bit for bit; history "
                f"{[h['n_changed'] for h in outs[0]['history']]} changed "
                f"against {[h['n_changed'] for h in hist1]}")
    log(f"  mesh launches (all worlds, summed over ranks): {launches}")
    log(f"mesh phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def _same_as_phase5(torch, ref5, hist, traj, rho, sums, labels, sims, what,
                    sums_want=None):
    """A mesh fit against phase 5's, bit for bit."""
    fields = ("iteration", "n_changed", "n_candidates", "cpr", "objective",
              "t_th", "v_th")
    strip = lambda h: {f: h[f] for f in fields}
    require([strip(h) for h in hist] == [strip(h) for h in ref5["history"]],
            f"{what}: history differs from phase 5's: {hist} vs "
            f"{ref5['history']}")
    require(len(traj) == len(ref5["traj"]) and all(
        torch.equal(a.cpu(), b) for a, b in zip(traj, ref5["traj"])),
        f"{what}: an iteration's assignment differs from phase 5's")
    require(torch.equal(rho, ref5["rho"]), f"{what}: ρ_self differs")
    require(torch.equal(sums, ref5["sums"] if sums_want is None
                        else sums_want), f"{what}: means differ")
    require(torch.equal(labels, ref5["labels"])
            and torch.equal(sims, ref5["sims"]),
            f"{what}: the mesh classify differs from phase 5's classify")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=200_000,
                    help="documents of the NYT-width corpus (paper: 1,285,944)")
    ap.add_argument("--max-iter", type=int, default=6)
    ap.add_argument("--mode-iter", type=int, default=4,
                    help="iterations of the sketch and bounds-esicp fits")
    ap.add_argument("--small-iter", type=int, default=8,
                    help="iterations of the small cross-check's other modes")
    ap.add_argument("--ivf-iter", type=int, default=4,
                    help="max_iter of the two-level fit's coarse and cell "
                         "fits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-batch", type=int, default=2,
                    help="batch of the LM prefills")
    ap.add_argument("--lm-seq", type=int, default=4096,
                    help="tokens per row of the LM prefills")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.configs import nyt1m

    global NYT_VOCAB, NYT_NT_MEAN, NYT_K
    job = nyt1m.config()
    NYT_VOCAB, NYT_NT_MEAN, NYT_K = job.vocab, job.nt_mean, job.k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi_line = device_phase(torch)
    build_phase()

    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.sparse.matrix import with_df

    t0 = phase("corpus")
    spec = CorpusSpec(n_docs=args.n_docs, vocab=NYT_VOCAB,
                      nt_mean=NYT_NT_MEAN, n_topics=100, seed=args.seed)
    docs, df, _, _ = make_corpus(spec, device="cuda")
    torch.cuda.synchronize()
    log(f"corpus {spec} -> N {docs.n_docs} P {docs.pad_width} nnz "
        f"{int(docs.nnz.sum())} in {time.perf_counter() - t0:.1f} s")

    rows = kernel_phase(torch, docs, args.seed)
    variant_launches, small = small_phase(torch, args.seed, args.small_iter)
    launches, model, cls, flat_peak, flat_own = main_phase(torch, docs, df,
                                                 args.max_iter)
    ref5 = mesh_record(torch, model, cls)
    breakdown_phase(torch, docs, df, model)
    serve_launches, refit_rec = serving_phase(torch, docs, model, cls,
                                              args.seed)
    esicp_traj, esicp_hist = model.trajectory, model.history
    resident = resident_record(torch, model, cls)
    del model, cls
    torch.cuda.empty_cache()
    paths = {name: ["esicp fit + classify"] for name in PATH_KERNELS["esicp"]}
    for name in PATH_KERNELS["serving"]:
        launches[name] += serve_launches[name]
        paths[name].append("serving: graph replays" if name == "sparse_sim"
                           else "serving: refit")
    for algo in ("sketch", "bounds-esicp"):
        got, model = mode_phase(torch, docs, df, algo, args.mode_iter,
                                esicp_traj)
        for name in PATH_KERNELS[algo]:
            launches[name] += got[name]
            paths.setdefault(name, []).append(f"{algo} fit")
        breakdown_phase(torch, docs, df, model, algo, est=False)
        if algo == "sketch":
            # The untuned ρ_self after --mode-iter iterations.
            mode_rho = model.rho_self.cpu()
            del model
            torch.cuda.empty_cache()
    rows.update(sketch_kernel_phase(torch, docs, model))
    fitted_rho(torch, docs, model, rows["rho_gather"])
    del model
    torch.cuda.empty_cache()
    got, rows["routed_scan"], ivf = ivf_phase(torch, docs, df, args.ivf_iter,
                                              args.seed, flat_peak)
    launches["routed_scan"] = got["routed_scan"]
    paths["routed_scan"] = ["two-level routed classify",
                            "two-level serving: graph replays"]
    for name in PATH_KERNELS["two_level"][:-1]:
        launches[name] += got[name]
        paths[name].append("two-level fit" if name != "sparse_sim"
                           else "two-level classify and serving")
    for name, (count, algo) in variant_launches.items():
        launches[name] = count
        paths[name] = [f"small cross-check {algo} fit on the card"]

    # The out-of-core plane: the corpus leaves the card for a disk store.
    docs_h = docs.to("cpu")
    del docs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        store = write_store(docs_h, tmp)
        got = ivf_store_phase(torch, store, df, args.ivf_iter, ivf)
        for name in PATH_KERNELS["two_level store"]:
            launches[name] += got[name]
            paths.setdefault(name, []).append("two-level fit over the store")
        del ivf
        torch.cuda.empty_cache()
        got, rows["segment_update_init"], seed_rows, refit_got = \
            streaming_phase(torch, store, docs_h, df, resident, refit_rec,
                            args.max_iter)
        del resident, refit_rec
        launches["segment_update_init"] += got["segment_update_init"]
        paths["segment_update_init"] = ["two-level fit over the store",
                                        "streaming esicp fit"]
        for name in PATH_KERNELS["store refit"]:
            launches[name] += refit_got[name]
            paths[name].append("store refit")
        minibatch_phase(torch, store, seed_rows)
        del store
    small_store_phase(torch, small)
    # The tuner last: the corpus back on the card, nothing else there, and
    # the host copies of the resident and refit models gone before its
    # artifact (one (D, K) matrix) goes to disk and back.
    docs = docs_h.to("cuda")
    del docs_h, small
    got, settings_ms = tune_phase(torch, docs, df, args.mode_iter,
                                  esicp_hist, esicp_traj, mode_rho,
                                  flat_own, args.seed)
    for name in PATH_KERNELS["tune"]:
        launches[name] += got[name]
        paths[name].append("tuned fits (search; cached after a load)")
    for name, ms in settings_ms.items():
        rows[name].setdefault("extra", {})["settings_ms"] = ms
    # The mesh fit builds a term-major layout for each λ span of its rows;
    # the layout the earlier fits built for the corpus would sit beside
    # them (with it, the world of one's peak rose 2.37 GiB above phase
    # 5's on the full corpus).  A fresh corpus object drops it, so the
    # peak compares with phase 5's, which built one layout.
    docs = with_df(docs, df)
    torch.cuda.empty_cache()
    got = mesh_phase(torch, docs, df, ref5, args.max_iter, flat_peak)
    for name in PATH_KERNELS["mesh"]:
        launches[name] += got[name]
        paths.setdefault(name, []).append(
            "mesh fits and mesh classify (world of one, (1, 2), (2, 1), "
            "(2, 2))")
    del docs, df, ref5
    torch.cuda.empty_cache()

    rows["flash_attention"] = lm_kernel_phase(torch, args.seed, args.lm_batch,
                                              args.lm_seq)
    lm_small_phase(torch, args.seed)
    launches["flash_attention"], run_launches = lm_main_phase(
        torch, args.seed, args.lm_batch, args.lm_seq)
    from repro_torch.configs import registry

    launches["slstm_scan"] = 0
    paths["flash_attention"] = ["gemma3-1b prefill"]
    paths["slstm_scan"] = []
    for title, entries in (("lm families", LM_FAMILY), ("lm ssm", LM_SSM)):
        got, run = lm_family_phase(torch, title, entries, args.seed,
                                   args.lm_batch, args.lm_seq)
        run_launches += run
        for name in ("flash_attention", "slstm_scan"):
            launches[name] += got[name]
            paths[name] += [f"{e[0]} prefill" for e in entries
                            if kind_counts(registry.get_config(e[0]))[name]]
    rows["flash_attention"]["extra"]["launches_in_run"] = run_launches

    rows.update(train_kernel_phase(torch, args.seed, args.lm_batch))
    train_small_phase(torch, args.seed)
    train = train_main_phase(torch, args.seed, args.lm_batch, args.lm_seq)
    for name, arch in (("flash_attention_bwd", "gemma3-1b"),
                       ("slstm_scan_bwd", "xlstm-125m")):
        launches[name] = train["runs"][arch]["launches"][name]
        paths[name] = [f"{arch} training, 3 steps"]
        rows[name]["extra"]["train"] = train["runs"][arch]
        rows[name]["extra"]["f32_parity"] = train["parity"][arch]
        fwd = name[:-4]
        rows[fwd]["extra"]["train_launches"] = \
            train["runs"][arch]["launches"][fwd]

    kernels = []
    for name in SOURCES:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "path": ", ".join(paths[name]), **r.get("extra", {}),
            **({"by_window": r["by_window"]} if "by_window" in r else {})})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
