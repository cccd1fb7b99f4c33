#!/usr/bin/env python3
"""segment_update against another revision of it, under one timer.

    python3 scripts/segment_update_probe.py [--other PATH/segment_update.cu]
                                            [--n-docs N] [--seed S]
                                            [--rounds R]

Needs one CUDA GPU (built for sm_90a).  On the NYT-width corpus of
``--n-docs`` documents that ``chip_smoke.py`` makes (D 495,126, K
10,000), with ``chip_smoke.py``'s seeded random assignment (every 97th
document assigned K): the one-call launch over the whole corpus, as the
resident update makes it, from this checkout's ``csrc/segment_update.cu``
and from every ``--other`` revision's (either C interface: without the
``accumulate`` argument, as before the streaming fit, or with it), each
held bit for bit against this checkout's result and timed by
``chip_smoke.time_ms`` in turns other, this, this, other for
``--rounds`` rounds.  Then the accumulating launch (``init``) on the
corpus's first 32,768 documents onto a copy of the sums, this checkout's
and every ``--other`` revision's that has one, each held bit for bit
against this checkout's and timed the same way.

Prints the card's name and power limit first and a JSON object as the
last line (also written to build/probe/segment_update_probe.json).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (NYT_K, NYT_NT_MEAN, NYT_VOCAB,  # noqa: E402
                        STREAM_CHUNK, time_ms)
from scripts.sketch_sim_probe import PROBE_BUILD, compile_all, smi  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def other_launch(torch, lib, path: Path):
    """(launch(layout, assign, lam_t), its accumulating launch or None)
    from another revision's source."""
    accumulate = "int accumulate" in path.read_text()
    f = lib.segment_update_launch
    f.restype = _I
    f.argtypes = [_P] * 5 + [_I, _I] + ([_I] if accumulate else []) + [_P, _P]

    def run(layout, assign, lam_t, flag=0):
        d, k = lam_t.shape
        args = [layout.ptr.data_ptr(), layout.rows.data_ptr(),
                layout.vals.data_ptr(), layout.order.data_ptr(),
                assign.data_ptr(), d, k] + ([flag] if accumulate else []) + [
                    lam_t.data_ptr(), torch.cuda.current_stream().cuda_stream]
        rc = f(*args)
        if rc:
            raise RuntimeError(f"{path}: segment_update launch error {rc}")

    return run, ((lambda *a: run(*a, flag=1)) if accumulate else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/segment_update.cu")
    ap.add_argument("--n-docs", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("segment_update_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_update as kern
    from repro_torch.sparse.matrix import SparseDocs

    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    libs = compile_all(list(args.other))
    docs, _, _, _ = make_corpus(CorpusSpec(
        n_docs=args.n_docs, vocab=NYT_VOCAB, nt_mean=NYT_NT_MEAN,
        n_topics=100, seed=args.seed), device="cuda")
    d, k, n = docs.dim, NYT_K, docs.n_docs
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    assign = torch.randint(0, k, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
    assign[::97] = k
    layout = docs.by_term
    lam = torch.empty((d, k), dtype=torch.float32, device="cuda")
    want = ops.segment_update(assign, docs, k=k)

    def same(a, b) -> bool:
        step = 1 << 14
        return all(torch.equal(a[s:s + step], b[s:s + step])
                   for s in range(0, d, step))

    runs = {"this": lambda: kern.launch(layout, assign, lam)}
    accs = {}
    for src, lib in libs.items():
        one, acc = other_launch(torch, lib, src)
        runs[str(src)] = (lambda f: lambda: f(layout, assign, lam))(one)
        if acc is not None:
            accs[str(src)] = acc
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        if not same(lam, want):
            raise SystemExit(f"FAILED: {name} differs from this checkout's "
                             "sums")
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name in [*runs][1:] + ["this", "this"] + [*runs][1:]:
            times[name].append(time_ms(torch, runs[name]))
    for name, ts in times.items():
        print(f"segment_update one call, {name}: median "
              f"{statistics.median(ts):.4f} ms of {[round(t, 4) for t in ts]}",
              flush=True)
    del lam

    m = min(n, STREAM_CHUNK)
    chunk = SparseDocs(docs.ids[:m], docs.vals[:m], docs.nnz[:m], d)
    a0 = assign[:m].contiguous()
    c_layout = chunk.by_term
    init_want = ops.segment_update(a0, chunk, k=k, init=want.clone())
    init = want.clone()
    init_runs = {"this": lambda: ops.segment_update(a0, chunk, k=k,
                                                    init=init)}
    for name, acc in accs.items():
        init_runs[name] = (lambda f: lambda: f(c_layout, a0, init))(acc)
    for name, fn in init_runs.items():
        init.copy_(want)
        fn()
        torch.cuda.synchronize()
        if not same(init, init_want):
            raise SystemExit(f"FAILED: init, {name} differs from this "
                             "checkout's sums")
    init_ms = {name: [] for name in init_runs}
    for _ in range(args.rounds):
        for name in [*init_runs][1:] + ["this", "this"] + [*init_runs][1:]:
            init_ms[name].append(time_ms(torch, init_runs[name]))
    for name, ts in init_ms.items():
        print(f"segment_update init on {m} documents, {name}: median "
              f"{statistics.median(ts):.4f} ms of "
              f"{[round(t, 4) for t in ts]}", flush=True)
    result = {"card": card, "n_docs": n,
              "one_call_ms": {name: ts for name, ts in times.items()},
              "init_ms": init_ms}
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    (PROBE_BUILD / "segment_update_probe.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
