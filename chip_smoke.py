#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--n-docs N] [--max-iter R] [--seed S]
                          [--lm-batch B] [--lm-seq S]

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
             version on the live values and against a second run, with
             the bound of its live tuples beside the old all-slots one;
             after phase 8 also on the bounds-esicp fit's labels and means.
             segment_update runs from the term-major layout the corpus
             builds once (its build time and bytes printed), twice and held
             bitwise, and bit for bit against the CPU plain version at
             20,000 documents x K 1,000;
4. small   — small fits on the card and on the CPU (plain versions), all
             nine algorithm modes (ES-ICP to convergence, the other eight
             to ``--small-iter`` iterations), and a classify: identical
             assignments after every iteration and identical integer
             history (Mult, |Z|, changed, n_moving, t_th);
5. main    — ``repro_torch.cluster.fit`` (ES-ICP, k 10,000, EstParams at
             iterations 1–2) and ``classify_docs`` on a synthetic corpus at
             the NYT widths of ``configs/nyt1m.py`` (vocab 495,126, nt_mean
             225.76), n_docs cut from 1,285,944 to ``--n-docs``.  Launch
             counters are zeroed just before and read just after: every
             kernel of the path must have launched and no plain version may
             have run;
6. breakdown — one more iteration from the fitted state, timed phase by
             phase (assignment epoch, update step, EstParams), here and
             after each fit of phase 7;
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

Then, with the clustering phases' memory freed, the LM serving path
(gemma3-1b, ``src/repro_torch/configs/gemma3_1b.py``):

9. lm kernels — flash_attention against its plain version at the
             model's shapes (BH 8, S 4096, hd 256, window 512 and -1,
             unit-normal inputs), at (3, 200, 136, 64) window 48 (rows
             with no live key), max abs err ≤ 2e-5, and at (2, 1024, 256)
             full causal with q, k scaled by 6 (scores ≈ 30) within 2e-5
             of the plain version in float64; times from CUDA events
             beside the plain version, ``scaled_dot_product_attention``
             and two bounds (split-TF32 on the tensor cores, fp32 on the
             CUDA cores); each instantiation's registers, spills (none
             allowed), shared memory and blocks an SM;
10. lm small — the gemma3 smoke config, parameters made on the CPU from
             ``--seed`` and carried to the card, float32 compute on both:
             prefill logits within 1e-4 and identical greedy tokens from
             ``ServeLoop.generate`` (B 2, prompt 8, 16 new); on the card
             the kernel launched and no plain version ran;
11. lm main — gemma3-1b at full width, seeded weights on the card, bf16
             compute: ``make_prefill_fn`` on ``--lm-batch`` × ``--lm-seq``
             tokens (default 2 × 4096) with exactly one kernel launch per
             layer (26) and no plain call, finite logits; the same prefill
             with the plain attention agrees within twice the bf16 path's
             own rounding error (bf16 vs float32 compute, kernel path),
             top-1 included; ``ServeLoop(max_len=64).generate`` on B 4, a
             32-token prompt and 32 new tokens; torch.profiler's device
             time by kernel group, and the device's idle share, for one
             prefill and for 7 decode steps.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# TF32 products per fp32 operation in flash_attention (split-TF32:
# lo·hi + hi·lo + hi·hi).
TF32_PASSES = 3

NYT_VOCAB = 495_126
NYT_NT_MEAN = 225.76
NYT_K = 10_000
BATCH = 4096

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
}
# The kernels each main-path run must launch.
PATH_KERNELS = {
    "esicp": ("esicp_gather", "esicp_filter", "segment_update", "rho_gather",
              "sparse_sim"),
    "sketch": ("sparse_sim", "doc_sketch", "sketch_sim", "segment_update",
               "rho_gather"),
    "bounds-esicp": ("esicp_gather", "esicp_filter", "doc_sketch",
                     "sketch_sim", "segment_update", "rho_gather"),
}
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


def bound_ms(n_bytes: float, flops: float, rate: float = FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    # against the plain version on the live values, and on a second run
    # (the kernel's centroid order within a bin is free).
    rho = ops.rho_gather(assign, docs.ids, docs.vals, means_t, nnz=docs.nnz)
    check_equal(torch, "rho_gather", rho, ref.rho_gather(
        assign, docs.ids, vals_all, means_t))
    check_equal(torch, "rho_gather nnz", rho, ref.rho_gather(
        assign, docs.ids, docs.vals, means_t, nnz=docs.nnz))
    check_equal(torch, "rho_gather second run", rho, ops.rho_gather(
        assign, docs.ids, docs.vals, means_t, nnz=docs.nnz))
    check_equal(torch, "rho_gather without nnz", rho, ops.rho_gather(
        assign, docs.ids, vals_all, means_t))
    require(bool((rho[::97] == 0).all()), "rho_gather: assign = K must read 0")
    # The least bytes: each live tuple of a row assigned in [0, K) (8 B)
    # and its means entry (4 B), assign and ρ of every row, nnz of those.
    in_k = (assign >= 0) & (assign < k)
    live_in = int((vals_all != 0)[in_k].sum())
    n_in = int(in_k.sum())
    rows["rho_gather"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: ops.rho_gather(
            assign, docs.ids, docs.vals, means_t, nnz=docs.nnz)),
        plain_ms=time_ms(torch, lambda: ref.rho_gather(
            assign, docs.ids, vals_all, means_t), reps=3),
        library_ms=None,
        bound=bound_ms(live_in * 12 + n * 8 + n_in * 4, 2 * live_in),
        extra=dict(
            # The count held before the nnz operand: every slot's tuple.
            bound_all_slots_ms=bound_ms(n * p * 8 + n * 8 + nnz_all * 4,
                                        2 * nnz_all)[0],
            without_nnz_ms=time_ms(torch, lambda: ops.rho_gather(
                assign, docs.ids, vals_all, means_t)),
            live_vals_ms=time_ms(torch, docs.live_vals)))

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
    for name, r in rows.items():
        log(f"  {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound"
            f" {r['bound'][0]:.3f} ms by {r['bound'][1]}, library "
            f"{r['library_ms']}{extra_text(r)}) max abs err "
            f"{r['max_abs_err']:.3g}")
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")
    return rows


def fitted_rho(torch, docs, model, row) -> None:
    """rho_gather on a fitted state (the bounds-esicp fit's labels and
    means), the inputs the update gives it: bit for bit against the plain
    version, its time kept in the row as ``fitted_ms``."""
    from repro_torch.kernels import ops, ref

    args = (model.labels, docs.ids, docs.vals, model.index.means_t)
    got = ops.rho_gather(*args, nnz=docs.nnz)
    check_equal(torch, "rho_gather (fitted)", got,
                ref.rho_gather(*args, nnz=docs.nnz))
    row["extra"]["fitted_ms"] = time_ms(
        torch, lambda: ops.rho_gather(*args, nnz=docs.nnz))
    log(f"  rho_gather on the bounds-esicp fit's state: "
        f"{row['extra']['fitted_ms']:.4f} ms, bitwise equal to plain")


def tile_distinct(torch, ids, live, d: int, bt: int) -> int:
    """Σ over tiles of ``bt`` consecutive rows of the tile's distinct live
    ids: the row segments a document-tiled gather stages."""
    tile = torch.arange(ids.shape[0], device=ids.device) // bt
    keys = (tile[:, None] * d + ids.long())[live]
    return int(torch.unique(keys).numel())


def log_moved_bytes(torch, ids, live, d: int, k: int, rows) -> None:
    """Means-row bytes the gathers move to the SMs on this batch, beside
    their bound: one K-row per live tuple (a walk tuple by tuple), one per
    distinct row of each document tile (the tiled kernel), and one per
    distinct row of the batch (what the bound counts)."""
    from repro_torch.kernels.esicp_gather import ESICP, SIMS, library

    row = k * 4
    walk = int(live.sum()) * row
    distinct = tile_distinct(torch, ids, live, d, ids.shape[0]) * row
    for name, mode in (("sparse_sim", SIMS), ("esicp_gather", ESICP)):
        bt = library().gather_tile_docs(mode, 0)
        tiled = tile_distinct(torch, ids, live, d, bt) * row
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

    row = k * 4
    bt = library().gather_tile_docs(SQUARE, 0)
    tiled = tile_distinct(torch, ids, tail, d, bt)
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
    fits = {}
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
        fits[algo] = b
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
    return variant_launches


def main_phase(torch, docs, df, max_iter: int):
    from repro_torch.cluster import ClusterConfig, classify_docs, fit
    from repro_torch.kernels import ops

    t0 = phase(f"main path: fit k={NYT_K} esicp + classify, "
               f"N={docs.n_docs} D={docs.dim} P={docs.pad_width}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    model = fit(docs, ClusterConfig(k=NYT_K, algo="esicp", max_iter=max_iter,
                                    batch_size=BATCH), df=df,
                keep_trajectory=True)
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
    log(f"  peak device memory: {peak / 2**30:.2f} GiB "
        f"(one (D, K) float32 matrix: {docs.dim * NYT_K * 4 / 2**30:.2f} GiB)")
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
    return launches, model


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
        extra=dict(no_fma_floor_ms=ops_n / (FP32_FLOPS / 2) * 1e3,
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


def attention_bound(bh: int, sq: int, hd: int, window: int,
                    passes: float = 1):
    """(bound, live pairs) of one banded-causal attention call: 4·hd
    operations per live (query, key) pair against q, k, v read once and
    the output written once.  passes 1: fp32 on the CUDA cores; more:
    that many TF32 products per operation on the tensor cores."""
    pairs = sum(min(i + 1, window) if window >= 0 else i + 1
                for i in range(sq)) * bh
    rate = FP32_FLOPS if passes == 1 else TF32_FLOPS
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


def lm_kernel_phase(torch, seed: int):
    """flash_attention against its plain version: the model's shapes and a
    ragged shape with fully masked rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    t0 = phase("lm kernels: flash_attention")
    log_flash_resources()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = 2e-5
    bh, s, hd = 8, 4096, 256
    q, k, v = (torch.randn((bh, s, hd), generator=gen, device=dev)
               for _ in range(3))
    by_window = {}
    for window in (512, -1):
        got = ops.flash_attention(q, k, v, window=window)
        want = ref.flash_attention(q, k, v, window)
        err = check_close(torch, f"flash_attention window {window}", got,
                          want, tol)
        del want
        if window < 0:
            lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)
        else:
            pos = torch.arange(s, device=dev)
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < window))
            lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=band)
        lib_err = max_err(torch, lib(), got)
        bound, pairs = attention_bound(bh, s, hd, window, TF32_PASSES)
        fp32_bound, _ = attention_bound(bh, s, hd, window)
        by_window[window] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                          window=window)),
            plain_ms=time_ms(torch, lambda: ref.flash_attention(q, k, v,
                                                                window), reps=3),
            library_ms=time_ms(torch, lib), bound=bound,
            fp32_bound_ms=fp32_bound[0])
        r = by_window[window]
        log(f"  BH {bh} S {s} hd {hd} window {window}: {pairs} live pairs; "
            f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, sdpa "
            f"{r['library_ms']:.3f} ms); bound {bound[0]:.4f} ms by "
            f"{bound[1]} in {TF32_PASSES} TF32 passes on the tensor cores "
            f"({bound[0] / r['ms']:.1%} of it), {fp32_bound[0]:.4f} ms in "
            f"fp32 on the CUDA cores ({fp32_bound[0] / r['ms']:.1%}); max "
            f"abs err {err:.3g} (tolerance {tol}); sdpa vs kernel "
            f"{lib_err:.3g}")
    del q, k, v, got
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
    row = dict(by_window[-1])
    row["max_abs_err"] = max(err, err6,
                             *(r["max_abs_err"] for r in by_window.values()))
    row["extra"] = dict(fp32_bound_ms=row.pop("fp32_bound_ms"))
    row["by_window"] = {str(w): dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                     library_ms=r["library_ms"],
                                     bound_ms=r["bound"][0],
                                     fp32_bound_ms=r["fp32_bound_ms"],
                                     max_abs_err=r["max_abs_err"])
                        for w, r in by_window.items()}
    log(f"lm kernel checks passed in {time.perf_counter() - t0:.1f} s")
    return row


def lm_small_phase(torch, seed: int):
    """The gemma3 smoke config, float32 compute, on the card and on the
    CPU from the same parameters: prefill logits and greedy tokens."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params, tree_to
    from repro_torch.serve.lm import ServeLoop, make_prefill_fn

    t0 = phase("lm small cross-check (cuda vs cpu), gemma3 smoke config")
    cfg = gemma3_1b.smoke_config()
    gen = torch.Generator().manual_seed(seed)
    params = {"cpu": init_params(cfg, gen, device="cpu")}
    params["cuda"] = tree_to(params["cpu"], "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 37), generator=gen, dtype=torch.int32)
    prompts = toks[:, :8]
    f32 = torch.float32
    lg, out = {}, {}
    for dev in ("cuda", "cpu"):
        ops.reset_counts()
        lg[dev] = make_prefill_fn(cfg, compute_dtype=f32)(params[dev],
                                                          toks.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ops.LAUNCHES["flash_attention"]
            plain = ops.PLAIN["flash_attention"]
        out[dev] = ServeLoop(cfg, params[dev], compute_dtype=f32).generate(
            prompts.to(dev), n_new=16)
    err = check_close(torch, "lm small prefill logits cuda vs cpu",
                      lg["cuda"].cpu(), lg["cpu"], 1e-4)
    require(launches >= 1 and plain == 0,
            f"lm small: flash_attention launches {launches}, plain {plain}")
    require(torch.equal(out["cuda"].cpu(), out["cpu"]),
            f"lm small: greedy tokens differ cuda vs cpu:\n{out['cuda']}\n"
            f"{out['cpu']}")
    log(f"  prefill logits (2, {cfg.vocab}) max abs err {err:.3g} "
        f"(tolerance 1e-4); kernel launches {launches}, plain 0")
    log(f"  greedy tokens identical: {out['cpu'][:, 8:].tolist()}")
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


class plain_attention:
    """Routes the model's attention to the plain version on the card (for
    the parity prefill only) by swapping ops.flash_attention."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self.ops, self.kernel = ops, ops.flash_attention
        ops.flash_attention = lambda q, k, v, *, window=-1: \
            ref.flash_attention(q, k, v, window)

    def __exit__(self, *exc):
        self.ops.flash_attention = self.kernel


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

    # Parity: the same prefill with the plain attention, and the bf16
    # path's own rounding error (float32 compute, kernel path).
    with plain_attention():
        ops.reset_counts()
        plain_logits = prefill(params, tokens)
        require(ops.LAUNCHES["flash_attention"] == 0,
                "the parity prefill launched the kernel")
    ref32 = make_prefill_fn(cfg, compute_dtype=torch.float32)(params, tokens)
    run_launches += ops.LAUNCHES["flash_attention"]
    a, b = logits.float(), plain_logits.float()
    diff = float((a - b).abs().max())
    noise = float((a - ref32).abs().max())
    tol = 2 * noise
    log(f"  parity: kernel vs plain attention (bf16 path) max abs logit diff "
        f"{diff:.4g}; bf16 vs float32 compute (kernel) {noise:.4g}; "
        f"tolerance 2 × that = {tol:.4g}; logits max |x| "
        f"{float(a.abs().max()):.4g}")
    require(diff <= tol, f"kernel vs plain prefill logits differ by {diff} "
            f"> {tol}")
    top_a, top_b = a.argmax(-1), b.argmax(-1)
    for r in range(batch):
        i, j = int(top_a[r]), int(top_b[r])
        if i != j:
            gap = max(abs(float(a[r, i] - a[r, j])), abs(float(b[r, i] - b[r, j])))
            log(f"  row {r}: top-1 {i} vs {j}, logit gap {gap:.4g}")
            require(gap <= tol, f"row {r}: top-1 differs by a gap {gap} > {tol}")
    log(f"  top-1 equal in {int((top_a == top_b).sum())} of {batch} rows")
    del plain_logits, ref32, a, b, logits

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=200_000,
                    help="documents of the NYT-width corpus (paper: 1,285,944)")
    ap.add_argument("--max-iter", type=int, default=6)
    ap.add_argument("--mode-iter", type=int, default=4,
                    help="iterations of the sketch and bounds-esicp fits")
    ap.add_argument("--small-iter", type=int, default=8,
                    help="iterations of the small cross-check's other modes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-batch", type=int, default=2,
                    help="batch of the gemma3-1b prefill")
    ap.add_argument("--lm-seq", type=int, default=4096,
                    help="tokens per row of the gemma3-1b prefill")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi_line = device_phase(torch)
    build_phase()

    from repro_torch.data import CorpusSpec, make_corpus

    t0 = phase("corpus")
    spec = CorpusSpec(n_docs=args.n_docs, vocab=NYT_VOCAB,
                      nt_mean=NYT_NT_MEAN, n_topics=100, seed=args.seed)
    docs, df, _, _ = make_corpus(spec, device="cuda")
    torch.cuda.synchronize()
    log(f"corpus {spec} -> N {docs.n_docs} P {docs.pad_width} nnz "
        f"{int(docs.nnz.sum())} in {time.perf_counter() - t0:.1f} s")

    rows = kernel_phase(torch, docs, args.seed)
    variant_launches = small_phase(torch, args.seed, args.small_iter)
    launches, model = main_phase(torch, docs, df, args.max_iter)
    breakdown_phase(torch, docs, df, model)
    esicp_traj = model.trajectory
    del model
    torch.cuda.empty_cache()
    paths = {name: ["esicp fit + classify"] for name in PATH_KERNELS["esicp"]}
    for algo in ("sketch", "bounds-esicp"):
        got, model = mode_phase(torch, docs, df, algo, args.mode_iter,
                                esicp_traj)
        for name in PATH_KERNELS[algo]:
            launches[name] += got[name]
            paths.setdefault(name, []).append(f"{algo} fit")
        breakdown_phase(torch, docs, df, model, algo, est=False)
        if algo == "sketch":
            del model
            torch.cuda.empty_cache()
    rows.update(sketch_kernel_phase(torch, docs, model))
    fitted_rho(torch, docs, model, rows["rho_gather"])
    del model
    for name, (count, algo) in variant_launches.items():
        launches[name] = count
        paths[name] = [f"small cross-check {algo} fit on the card"]
    del docs, df
    torch.cuda.empty_cache()

    rows["flash_attention"] = lm_kernel_phase(torch, args.seed)
    lm_small_phase(torch, args.seed)
    launches["flash_attention"], run_launches = lm_main_phase(
        torch, args.seed, args.lm_batch, args.lm_seq)
    rows["flash_attention"]["extra"]["launches_in_run"] = run_launches
    paths["flash_attention"] = ["gemma3-1b prefill"]

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
