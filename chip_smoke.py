#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--n-docs N] [--max-iter R] [--seed S]

Needs one CUDA GPU of compute capability 9.0 (H100); exits non-zero
without one, or when the package is missing beside this script.  Phases,
each of which fails the run on any error:

1. device  — name, power limit and capability (must be 9.0);
2. build   — every CUDA source under src/repro_torch/csrc/, one nvcc each,
             in parallel, into build/kernels/;
3. kernels — each of the five kernels against its plain PyTorch version on
             the card at the main path's shapes (B 4096, K 10,000,
             D 495,126, P from the corpus), with the tolerance stated
             beside it; segment_update run twice and held bitwise; times
             from CUDA events;
4. small   — one small fit + classify on the card and on the CPU (plain
             versions): identical assignments after every iteration and
             identical integer history;
5. main    — ``repro_torch.cluster.fit`` (ES-ICP, k 10,000, EstParams at
             iterations 1–2) and ``classify_docs`` on a synthetic corpus at
             the NYT widths of ``configs/nyt1m.py`` (vocab 495,126, nt_mean
             225.76), n_docs cut from 1,285,944 to ``--n-docs``.  Launch
             counters are zeroed just before and read just after: every
             kernel must have launched and no plain version may have run;
6. breakdown — one more iteration from the fitted state, timed phase by
             phase (assignment epoch, update step, EstParams).

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
}
SOURCES = {
    "esicp_gather": "src/repro_torch/csrc/gather.cu",
    "esicp_filter": "src/repro_torch/csrc/esicp_filter.cu",
    "segment_update": "src/repro_torch/csrc/segment_update.cu",
    "rho_gather": "src/repro_torch/csrc/rho_gather.cu",
    "sparse_sim": "src/repro_torch/csrc/gather.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
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

    # segment_update over the whole corpus (the update's shape); every 97th
    # row is assigned K, which must contribute nothing.
    assign = torch.randint(0, k, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    assign[::97] = k
    lam = ops.segment_update(assign, docs.ids, vals_all, k=k, d=d)
    lam2 = ops.segment_update(assign, docs.ids, vals_all, k=k, d=d)
    _, _, same = chunked_compare(torch, lam, lam2, 0.0)
    require(same, "segment_update: two runs differ bitwise")
    del lam2
    ms = time_ms(torch, lambda: ops.segment_update(assign, docs.ids, vals_all,
                                                   k=k, d=d), reps=3)
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
        bound=bound_ms(n * p * 8 + n * 4 + d * k * 4, live_rows))

    # Realistic means: the normalised cluster sums of that assignment.
    means_t = normalized_means(lam, lam)
    del lam

    # rho_gather over the whole corpus.
    rho = ops.rho_gather(assign, docs.ids, vals_all, means_t)
    rho_p = ref.rho_gather(assign, docs.ids, vals_all, means_t)
    err = check_close(torch, "rho_gather", rho, rho_p, 1e-5)
    require(bool((rho[::97] == 0).all()), "rho_gather: assign = K must read 0")
    rows["rho_gather"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.rho_gather(assign, docs.ids, vals_all,
                                                 means_t)),
        plain_ms=time_ms(torch, lambda: ref.rho_gather(
            assign, docs.ids, vals_all, means_t), reps=3),
        library_ms=None,
        bound=bound_ms(n * p * 8 + n * 8 + nnz_all * 4, 2 * nnz_all))

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
    err = max(check_close(torch, f"esicp_gather.{nm}", g, w, 1e-5)
              for nm, g, w in zip(("rho12", "y", "sims"), got[:3], want[:3]))
    check_equal(torch, "esicp_gather.counts", got[3], want[3])
    log(f"  esicp_gather bitwise equal to plain: "
        f"{all(torch.equal(g, w) for g, w in zip(got, want))}")
    rows["esicp_gather"] = dict(
        max_abs_err=err,
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
    err = check_close(torch, "sparse_sim.sims", got[0], want[0], 1e-5)
    check_equal(torch, "sparse_sim.counts", got[1], want[1])
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
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.sparse_sim(b_ids, b_vals, means_t)),
        plain_ms=time_ms(torch, lambda: ref.sparse_sim(b_ids, b_vals,
                                                       means_t), reps=3),
        library_ms=time_ms(torch, lambda: torch.sparse.mm(csr, means_t)),
        bound=bound_ms(uniq * k * 4 + BATCH * p * 8 + BATCH * k * 4,
                       2 * b_nnz * k))
    log(f"  batch of {BATCH}: {b_nnz} live tuples over {uniq} distinct rows")
    del got, want, csr, means_t
    torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"  {name}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound"
            f" {r['bound'][0]:.3f} ms by {r['bound'][1]}, library "
            f"{r['library_ms']}) max abs err {r['max_abs_err']:.3g}")
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")
    return rows


def small_phase(torch, seed: int):
    """The same small fit + classify on the card and on the CPU."""
    from repro_torch.cluster import ClusterConfig, classify_docs, fit
    from repro_torch.core.lloyd import lloyd_fit
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.data import CorpusSpec, make_corpus

    t0 = phase("small cross-check (cuda vs cpu)")
    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=3000, vocab=4096,
                                            nt_mean=60, n_topics=16,
                                            seed=seed), device="cpu")
    k = 32
    rows = draw_seed_rows(docs.n_docs, k, seed=seed)
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = lloyd_fit(docs, k=k, algo="esicp", batch_size=1024,
                              max_iter=30, seed_rows=rows, df=df, device=dev,
                              keep_trajectory=True)
    a, b = runs["cuda"], runs["cpu"]
    ints = ("mult", "n_candidates", "n_changed", "n_moving", "t_th")
    require(a.n_iter == b.n_iter, f"iterations {a.n_iter} vs {b.n_iter}")
    for r, (ha, hb, ta, tb) in enumerate(zip(a.history, b.history,
                                             a.trajectory, b.trajectory)):
        require(torch.equal(ta, tb), f"assignments differ at iteration {r+1}")
        require(all(ha[f] == hb[f] for f in ints) and ha["v_th"] == hb["v_th"],
                f"history differs at iteration {r+1}: {ha} vs {hb}")
        log(f"  iter {r+1}: mult {ha['mult']} changed {ha['n_changed']} "
            f"objective cuda {ha['objective']:.6f} cpu {hb['objective']:.6f}")
    model = fit(docs, ClusterConfig(k=k, max_iter=30, batch_size=1024),
                df=df, seed_rows=rows)
    ca, _ = classify_docs(model.index, docs)
    cb, _ = classify_docs(model.index, docs, device="cpu")
    require(torch.equal(ca.cpu(), cb), "classify differs between cuda and cpu")
    require(torch.equal(model.labels.cpu(), b.assign),
            "fit() labels differ from the cpu lloyd_fit")
    log(f"identical over {a.n_iter} iterations and classify "
        f"({time.perf_counter() - t0:.1f} s)")


def main_phase(torch, docs, df, max_iter: int):
    from repro_torch.cluster import ClusterConfig, classify_docs, fit
    from repro_torch.kernels import ops

    t0 = phase(f"main path: fit k={NYT_K} esicp + classify, "
               f"N={docs.n_docs} D={docs.dim} P={docs.pad_width}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    model = fit(docs, ClusterConfig(k=NYT_K, algo="esicp", max_iter=max_iter,
                                    batch_size=BATCH), df=df)
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
    require(all(v > 0 for v in launches.values()),
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


def breakdown_phase(torch, docs, df, model):
    """Where one more iteration's time goes, phase by phase (host clock
    around work that ends in a synchronize), from the fitted state."""
    from repro_torch.core.backends import KernelBackend
    from repro_torch.core.estparams import estimate_params
    from repro_torch.core.lloyd import _epoch
    from repro_torch.core.update import KMeansState, n_ub_groups, update_step

    phase("breakdown of one more iteration")
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

    assign, ub, _, _, _ = timed("assignment epoch", lambda: _epoch(
        "esicp", bk, docs, state, BATCH))
    new = timed("update step", lambda: update_step(
        docs, assign, state.assign, state, state.index.params, k=NYT_K,
        backend=bk, ub=ub))
    del state
    timed("EstParams", lambda: estimate_params(
        docs, df, new.index.means_t, new.rho_self, k=NYT_K))
    for name, sec in out.items():
        log(f"  {name}: {sec:.3f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=200_000,
                    help="documents of the NYT-width corpus (paper: 1,285,944)")
    ap.add_argument("--max-iter", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
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
    small_phase(torch, args.seed)
    launches, model = main_phase(torch, docs, df, args.max_iter)
    breakdown_phase(torch, docs, df, model)
    del model

    kernels = []
    for name in ("esicp_gather", "esicp_filter", "segment_update",
                 "rho_gather", "sparse_sim"):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
