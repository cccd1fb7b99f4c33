#!/usr/bin/env python3
"""routed_scan against another revision of it, under one timer.

    python3 scripts/routed_scan_probe.py [--other PATH/routed_scan.cu]
                                         [--n-docs N] [--ivf-iter I]
                                         [--seed S]

Another revision's source comes from git, into the ignored build
directory, e.g. the parent's:

    mkdir -p build/probe/parent
    git show HEAD~1:src/repro_torch/csrc/routed_scan.cu \\
        > build/probe/parent/routed_scan.cu

Needs one CUDA GPU (built for sm_90a).  Builds ``chip_smoke.py``'s
NYT-width corpus of ``--n-docs`` documents and its two-level model
(``two_level_fit``, k 10,000, K_c 100, esicp, ``--ivf-iter`` iterations;
at the defaults the model of ``chip_smoke.py``'s two-level phase), then on
the first 4,096 documents at n_probe 1 and 4, on that batch sorted by its
best cell (n_probe 1), on it with its ids taken mod 256 (n_probe 1, the
same cells: the means it reads stay in L2, so the time without device
memory's), and at n_probe = K_c:

- this checkout's kernel (``kernels/routed_scan.launch``), on ``means_t``
  (K 10,000: four columns a thread) and on a copy of it that starts 4 bytes
  past a 16-byte boundary (the one-column path that models whose K is not
  a multiple of 4 take, on the same work);
- every ``--other`` ``routed_scan.cu``: either C interface, the one-block-a-
  document launch without scratch (``routed_scan_launch(ids, vals, nnz,
  means_t, cells, starts, sizes, B, P, K, n_probe, cmax, k_c, assign,
  best, scored, stream)``) or this one's (the same with the scratch from
  ``routed_scan_scratch_bytes`` before the outputs);

each held bit for bit against the plain version, timed with
``chip_smoke.time_ms`` (calls back to back) in turns other, this, this,
other, and once in a CUDA graph (``chip_smoke.graph_ms``), beside the
bound and the means sectors the blocks request (``chip_smoke.routed_work``);
and cuts of this checkout's source: its plan launch alone (what grouping
the batch by cell costs), and every gather reading one row of the means
(its instructions without the gathers' memory traffic).
Then the routed classify of the whole corpus (``classify_docs_routed``,
n_probe 1 and 4) with each revision's kernel in turn, held bit for bit
against this checkout's.

Prints the card's name and power limit first and a JSON object as the
last line (also written to build/probe/routed_scan_probe.json).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (BATCH, IVF_COARSE_K, NYT_NT_MEAN,  # noqa: E402
                        NYT_VOCAB, _ivf_config, bound_ms, graph_ms,
                        routed_work, time_ms)
from scripts.sketch_sim_probe import (PROBE_BUILD, compile_all,  # noqa: E402
                                     smi)

_P, _I = ctypes.c_void_p, ctypes.c_int
HOT_ROWS = 256      # the hot-rows batch: its ids mod this, means L2-resident
# Cuts of csrc/routed_scan.cu for the time breakdown; each text must match
# the source, or the probe stops.  "plan": the plan launch alone (the scan
# and finish launches skipped); "one row": every gather reads row 0 of the
# means, so the scan runs its instructions without the gathers' traffic
# (its answers are then wrong and not checked).
GATHER = "mc + static_cast<size_t>(t.x) * K, x[u]"
CUTS = {"plan": [("  routed_scan_tile<V>\n",
                  "  if (a.B < 0) routed_scan_tile<V>\n"),
                 ("  routed_scan_finish<<<",
                  "  if (a.B < 0) routed_scan_finish<<<")],
        "one row": [(GATHER, "mc, x[u]")]}


def cut_sources() -> dict[str, Path]:
    """{cut: path} of csrc/routed_scan.cu with each cut of ``CUTS`` made,
    in the probe's build directory."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "routed_scan.cu"
           ).read_text()
    out = {}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"routed_scan_probe: {old.strip()!r} is "
                                 f"not in csrc/routed_scan.cu")
            text = text.replace(old, new)
        path = PROBE_BUILD / f"cut_{name.replace(' ', '_')}" / "routed_scan.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out[name] = path
    return out


def other_launch(torch, lib, path: Path):
    """launch(ids, vals, nnz, means_t, cells, starts, sizes, cmax, assign,
    best, scored) from another revision's routed_scan.cu."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if hasattr(lib, "routed_scan_scratch_bytes"):
        f = lib.routed_scan_launch
        f.restype = _I
        f.argtypes = [_P] * 7 + [_I] * 6 + [_P] * 5
        nb = lib.routed_scan_scratch_bytes
        nb.restype = ctypes.c_longlong
        nb.argtypes = [_I] * 4

        def run(ids, vals, nnz, means_t, cells, starts, sizes, cmax,
                assign, best, scored):
            b, p = ids.shape
            scratch = torch.empty((nb(b, cells.shape[1], starts.shape[0],
                                      cmax),), dtype=torch.uint8,
                                  device=ids.device)
            return f(*(t.data_ptr() for t in (ids, vals, nnz, means_t, cells,
                                               starts, sizes)),
                     b, p, means_t.shape[1], cells.shape[1], cmax,
                     starts.shape[0], scratch.data_ptr(), assign.data_ptr(),
                     best.data_ptr(), scored.data_ptr(), stream())
    else:
        f = lib.routed_scan_launch
        f.restype = _I
        f.argtypes = [_P] * 7 + [_I] * 6 + [_P] * 4

        def run(ids, vals, nnz, means_t, cells, starts, sizes, cmax,
                assign, best, scored):
            b, p = ids.shape
            return f(*(t.data_ptr() for t in (ids, vals, nnz, means_t, cells,
                                               starts, sizes)),
                     b, p, means_t.shape[1], cells.shape[1], cmax,
                     starts.shape[0], assign.data_ptr(), best.data_ptr(),
                     scored.data_ptr(), stream())

    def launch(*args):
        rc = run(*args)
        if rc:
            raise RuntimeError(f"{path}: routed_scan launch error {rc}")

    return launch


def outputs(torch, b, dev):
    return (torch.empty((b,), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.float32, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/routed_scan.cu")
    ap.add_argument("--n-docs", type=int, default=200_000)
    ap.add_argument("--ivf-iter", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("routed_scan_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.cluster import classify_docs_routed
    from repro_torch.cluster.two_level import two_level_fit
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import routed_scan as kern

    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    cuts = cut_sources()
    libs = compile_all(list(args.other) + list(cuts.values()))
    docs, df, _, _ = make_corpus(CorpusSpec(
        n_docs=args.n_docs, vocab=NYT_VOCAB, nt_mean=NYT_NT_MEAN,
        n_topics=100, seed=args.seed), device="cuda")
    t = time.perf_counter()
    model = two_level_fit(docs, _ivf_config(args.ivf_iter), df=df).model
    torch.cuda.synchronize()
    print(f"N {docs.n_docs} P {docs.pad_width}; two-level fit "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    coarse_t, means_t, starts, sizes, cmax = model._routed_operands()
    dev = docs.device
    result = {"card": card, "n_docs": docs.n_docs, "cmax": cmax,
              "cases": {}, "classify_s": {}}

    # The same means 4 bytes past a 16-byte boundary: one column a thread.
    shifted = torch.empty((means_t.numel() + 1,), dtype=torch.float32,
                          device=dev)[1:].view(means_t.shape)
    shifted.copy_(means_t)
    this = {"this": kern.launch,
            "this, one column a thread": (
                lambda *a: kern.launch(*a[:3], shifted, *a[4:]))}
    others = {str(src): other_launch(torch, libs[src], src)
              for src in args.other}
    cut_runs = {name: other_launch(torch, libs[path], path)
                for name, path in cuts.items()}
    b_ids = docs.ids[:BATCH].contiguous()
    b_vals = docs.vals[:BATCH].contiguous()
    b_nnz = docs.nnz[:BATCH].contiguous()
    csims = ops.sparse_sim(b_ids, b_vals, coarse_t)[0]
    order = torch.sort(csims, dim=1, descending=True, stable=True).indices
    by_cell = torch.sort(order[:, 0], stable=True).indices
    for n_probe, sort, hot in ((1, False, False), (4, False, False),
                               (1, True, False), (1, False, True),
                               (IVF_COARSE_K, False, False)):
        rows = by_cell if sort else slice(None)
        cells = order[rows, :n_probe].to(torch.int32).contiguous()
        ids = b_ids[rows] % HOT_ROWS if hot else b_ids[rows]
        a = (ids.contiguous(), b_vals[rows].contiguous(),
             b_nnz[rows].contiguous(), means_t, cells, starts, sizes, cmax)
        name = (f"n_probe {n_probe}" + (" sorted by cell" if sort else "")
                + (f" hot rows (ids mod {HOT_ROWS})" if hot else ""))
        want = ref.routed_scan(*a)
        work = routed_work(torch, *a[:3], cells, starts, sizes)
        case = {"bound_ms": bound_ms(work["bytes"], work["flops"])[0],
                "means_block_bytes": work["blocks"],
                "means_request_bytes": work["requests"], "ms": {},
                "graph_ms": {}}
        fns = {}
        for label, launch in {**this, **others}.items():
            out = outputs(torch, BATCH, dev)
            fns[label] = lambda launch=launch, out=out: launch(*a, *out)
            fns[label]()
            for nm, g, w in zip(("assign", "best", "scored"), out, want):
                if not torch.equal(g, w):
                    raise SystemExit(f"{label} {name}: {nm} differs from "
                                     f"the plain version")
        turns = (list(others) + ["this"] + ["this"] + list(others)
                 + [k for k in this if k != "this"])
        for label in turns:
            case["ms"].setdefault(label, []).append(time_ms(torch,
                                                            fns[label]))
        for label in fns:
            case["graph_ms"][label] = graph_ms(torch, fns[label], calls=20)
        out = outputs(torch, BATCH, dev)
        case["cut_graph_ms"] = {
            name: graph_ms(torch, lambda run=run: run(*a, *out), calls=20)
            for name, run in cut_runs.items()}
        result["cases"][name] = case
        print(f"{name}: bound {case['bound_ms']:.4f} ms (means blocks "
              f"{work['blocks']:.4g} B, requested sectors "
              f"{work['requests']:.4g} B); cuts in a graph, ms: "
              f"{case['cut_graph_ms']}", flush=True)
        for label in fns:
            print(f"  {label}: {case['ms'][label]} ms back to back, "
                  f"{case['graph_ms'][label]:.4f} ms in a graph, bitwise "
                  f"equal to plain", flush=True)
    del csims, order

    # The routed classify of the whole corpus with each revision's kernel.
    own = kern.launch
    try:
        for n_probe in (1, 4):
            want = classify_docs_routed(model, docs, n_probe=n_probe,
                                        batch_size=BATCH)
            secs = {}
            for label in list(others) + ["this"] + ["this"] + list(others):
                kern.launch = own if label == "this" else others[label]
                got = classify_docs_routed(model, docs, n_probe=n_probe,
                                           batch_size=BATCH)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"classify with {label} differs")
                torch.cuda.synchronize()
                t = time.perf_counter()
                classify_docs_routed(model, docs, n_probe=n_probe,
                                     batch_size=BATCH)
                torch.cuda.synchronize()
                secs.setdefault(label, []).append(time.perf_counter() - t)
            result["classify_s"][f"n_probe {n_probe}"] = secs
            print(f"routed classify n_probe {n_probe}, s: {secs}", flush=True)
    finally:
        kern.launch = own
    out = PROBE_BUILD / "routed_scan_probe.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
