#!/usr/bin/env python3
"""doc_sketch and rho_gather against another revision of them, under one
timer.

    python3 scripts/small_kernel_probe.py [--other PATH/sketch.cu]
                                          [--other PATH/rho_gather.cu]
                                          [--n-docs N] [--seed S]

Needs one CUDA GPU (built for sm_90a).  On the NYT-width corpus of
``--n-docs`` documents that ``chip_smoke.py`` makes (D 495,126, K 10,000):

- the device time of an empty kernel's launch
  (``chip_smoke.empty_launch_ms``);
- ``doc_sketch`` on the first 4,096 documents (S 64, P from the corpus):
  this checkout's and every ``--other`` ``sketch.cu``'s (either C
  interface: ``doc_sketch_launch(ids, vals, B, P, g, S, out, stream)``, or
  the reciprocal's ``(ids, vals, B, P, magic, shift, S, out, stream)``),
  each held bit for bit against the plain version and timed in a CUDA
  graph (``graph_ms``) and back to back (``time_ms``); then where
  this checkout's kernel spends its time: copies of ``csrc/sketch.cu``
  built with the walk left out (copy and convert only), with the
  conversion left out too (copy only), and returning at once (launch of
  its grid), each timed in a CUDA graph;
- ``rho_gather`` over the whole corpus for two assignments: the seeded
  random one of ``chip_smoke.py``'s kernel phase (every 97th document K)
  and one that follows the corpus's topics (topic t's documents dealt
  round-robin to the 100 centroids 100·t .. 100·t + 99, as a fit splits a
  topic), each with the normalised cluster sums of that assignment as
  means.  Timed, each held bit for bit against the plain version on the
  live values: this checkout's with ``nnz`` (as the update calls it) and
  with every slot read (on the live values); every ``--other``
  ``rho_gather.cu`` (a C interface with nnz and scratch), which may sum
  in another order, within 1e-6 relative; and the ``live_vals`` pass the
  update once made; in turns
  other, this, this, other.  Beside them the live tuples and the distinct
  32-byte sectors of means_t that they touch: the least means bytes, with
  every sector fetched once.

Prints the card's name and power limit first and a JSON object as the
last line (also written to build/probe/small_kernel_probe.json).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (BATCH, NYT_K, NYT_NT_MEAN, NYT_VOCAB,  # noqa: E402
                        empty_launch_ms, graph_ms, time_ms)
from scripts.sketch_sim_probe import (PROBE_BUILD, compile_all,  # noqa: E402
                                     smi)

TOPIC_SPLIT = 100
_P, _I = ctypes.c_void_p, ctypes.c_int


def other_doc_sketch(torch, lib, path: Path):
    """doc_sketch(ids, vals, d, s) from another revision's sketch.cu."""
    if "unsigned magic" in path.read_text():
        return cut_doc_sketch(torch, lib)
    f = lib.doc_sketch_launch
    f.restype = _I
    f.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P]

    def run(ids, vals, d, s):
        b, pw = ids.shape
        out = torch.empty((b, s), dtype=torch.float32, device=ids.device)
        rc = f(ids.data_ptr(), vals.data_ptr(), b, pw, -(-d // s), s,
               out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{path}: doc_sketch launch error {rc}")
        return out

    return run


def other_rho(torch, lib, path: Path):
    """rho_gather(assign, ids, vals, nnz, means_t) from another revision's
    rho_gather.cu (the C interface with nnz and scratch)."""
    f = lib.rho_gather_launch
    f.restype = _I
    f.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]

    def run(assign, ids, vals, nnz, means_t):
        b, pw = ids.shape
        d, k = means_t.shape
        out = torch.empty((b,), dtype=torch.float32, device=ids.device)
        scratch = torch.empty((b + k + 1,), dtype=torch.int32,
                              device=ids.device)
        rc = f(assign.data_ptr(), ids.data_ptr(), vals.data_ptr(),
               nnz.data_ptr(), means_t.data_ptr(), b, pw, d, k,
               scratch.data_ptr(), out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{path}: rho_gather launch error {rc}")
        return out

    return run


# Cuts of csrc/sketch.cu's doc_sketch kernel for the time breakdown: each
# (text, replacement) must match the source, or the probe stops.
NO_WALK = ("    for (int j0 = 0; j0 <= n; j0 += kDsAhead) {",
           "    for (int j0 = 0; j0 <= n && P < 0; j0 += kDsAhead) {")
NO_CONVERT = ("    for (int ii = 0; ii < kDsRows / kDsWarps; ++ii) {",
              "    for (int ii = 0; ii < 0; ++ii) {")
FIRST = ("  // Two chunks of (id, v), converted in place to (slot, bits of "
         "v*v).\n")
RETURN = (FIRST, "  if (P >= 0) return;\n" + FIRST)
CUTS = {"copy and convert": [NO_WALK], "copy": [NO_WALK, NO_CONVERT],
        "grid launch": [RETURN]}


def sketch_cuts() -> dict[str, Path]:
    """{cut: path} of csrc/sketch.cu with each cut of ``CUTS`` made."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "sketch.cu").read_text()
    out = {}
    for name, edits in CUTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"cut {name!r}: source text not found")
            text = text.replace(old, new)
        path = PROBE_BUILD / f"sketch_cut_{name.replace(' ', '_')}.cu"
        path.write_text(text)
        out[name] = path
    return out


def cut_doc_sketch(torch, lib):
    """doc_sketch(ids, vals, d, s) from a source with the reciprocal's C
    interface (this checkout's, a cut of it, or another revision's)."""
    from repro_torch.kernels.sketch_sim import group_reciprocal

    f = lib.doc_sketch_launch
    f.restype = _I
    f.argtypes = [_P, _P, _I, _I, ctypes.c_uint, _I, _I, _P, _P]

    def run(ids, vals, d, s):
        b, pw = ids.shape
        magic, shift = group_reciprocal(-(-d // s))
        out = torch.empty((b, s), dtype=torch.float32, device=ids.device)
        rc = f(ids.data_ptr(), vals.data_ptr(), b, pw, magic, shift, s,
               out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"doc_sketch cut: launch error {rc}")
        return out

    return run


def in_turns(torch, fns: dict, want, near=()) -> dict:
    """Each fn held bit for bit against ``want`` (those named in ``near``,
    which sum in another order, within 1e-6 relative), then timed in the
    turns a, b, ..., b, a (time_ms); {name: [ms, ms]}."""
    for name, fn in fns.items():
        got = fn()
        same = (torch.allclose(got, want, rtol=1e-6, atol=1e-7)
                if name in near else torch.equal(got, want))
        if not same:
            raise SystemExit(f"{name}: differs from the plain version")
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(time_ms(torch, fns[name]))
    return times


def sectors(torch, docs, assign, k: int) -> tuple[int, int]:
    """(live tuples of the rows assigned in [0, K), distinct 32-byte
    sectors means_t[id, 8c .. 8c + 7] they read)."""
    ok = (assign >= 0) & (assign < k)
    live = docs.row_mask() & (docs.vals != 0) & ok[:, None]
    key = (docs.ids.long() * -(-k // 8)
           + (assign.long() // 8)[:, None])[live]
    return int(key.numel()), int(torch.unique(key).numel())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/sketch.cu or "
                         "csrc/rho_gather.cu to time too")
    ap.add_argument("--n-docs", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("small_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.meanindex import normalized_means, sketch_size
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.kernels import ops, ref

    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    cuts = sketch_cuts()
    libs = compile_all(list(args.other) + list(cuts.values()))
    docs, _, _, topics = make_corpus(CorpusSpec(
        n_docs=args.n_docs, vocab=NYT_VOCAB, nt_mean=NYT_NT_MEAN,
        n_topics=100, seed=args.seed), device="cuda")
    dev, d, k = docs.device, docs.dim, NYT_K
    n, p = docs.ids.shape
    result = {"card": card, "n_docs": n, "pad_width": p,
              "empty_launch_ms": empty_launch_ms(torch)}
    print(f"N {n} P {p} D {d} K {k}; empty kernel launch "
          f"{result['empty_launch_ms']:.5f} ms (graph)", flush=True)

    # doc_sketch on the chip_smoke batch.
    s = sketch_size(d)
    ids = docs.ids[:BATCH].contiguous()
    vals = docs.vals[:BATCH].contiguous()
    want = ref.doc_sketch(ids, vals, d, s)
    fns = {"this": lambda: ops.doc_sketch(ids, vals, d, s)}
    for src in args.other:
        if src.stem == "sketch":
            run = other_doc_sketch(torch, libs[src], src)
            fns[str(src)] = lambda run=run: run(ids, vals, d, s)
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise SystemExit(f"doc_sketch {name}: differs from plain")
    sk = {}
    for name in list(fns) + list(fns)[::-1]:
        row = sk.setdefault(name, {"graph_ms": [], "eager_ms": []})
        row["graph_ms"].append(graph_ms(torch, fns[name]))
        row["eager_ms"].append(time_ms(torch, fns[name]))
    for name, row in sk.items():
        print(f"doc_sketch {name}: graph {row['graph_ms']} ms, eager "
              f"{row['eager_ms']} ms, bitwise equal to plain", flush=True)
    result["doc_sketch"] = sk
    cut_ms = {}
    for name, path in cuts.items():
        run = cut_doc_sketch(torch, libs[path])
        cut_ms[name] = graph_ms(torch, lambda run=run: run(ids, vals, d, s))
        print(f"doc_sketch cut to {name}: {cut_ms[name]:.5f} ms (graph)",
              flush=True)
    result["doc_sketch cuts"] = cut_ms
    del want

    # rho_gather over the corpus, for two assignments.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    random = torch.randint(0, k, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    random[::97] = k
    by_topic = (topics.long() * TOPIC_SPLIT
                + torch.arange(n, device=dev) % TOPIC_SPLIT).to(torch.int32)
    live_vals = docs.live_vals()
    full = torch.full_like(docs.nnz, docs.pad_width)
    result["live_vals_ms"] = time_ms(torch, docs.live_vals)
    print(f"live_vals pass: {result['live_vals_ms']:.4f} ms", flush=True)
    others = [(str(src), other_rho(torch, libs[src], src))
              for src in args.other if src.stem == "rho_gather"]
    for label, assign in (("random", random), ("topics", by_topic)):
        lam = ops.segment_update(assign, docs, k=k)
        means_t = normalized_means(lam, lam)
        del lam
        want = ref.rho_gather(assign, docs.ids, docs.vals, means_t,
                              docs.nnz)
        fns = {name: (lambda run=run: run(assign, docs.ids, live_vals,
                                          docs.nnz, means_t))
               for name, run in others}
        fns["this, nnz"] = lambda: ops.rho_gather(
            assign, docs.ids, docs.vals, means_t, docs.nnz)
        fns["this, live values"] = lambda: ops.rho_gather(
            assign, docs.ids, live_vals, means_t, full)
        times = in_turns(torch, fns, want, near=[n for n, _ in others])
        tuples, n_sec = sectors(torch, docs, assign, k)
        result[f"rho_gather {label}"] = {"ms": times, "live_tuples": tuples,
                                         "sectors": n_sec}
        print(f"rho_gather, {label} assignment: {tuples} live tuples, "
              f"{n_sec} distinct means sectors ({n_sec * 32 / 1e9:.4f} GB "
              f"if each is fetched once; {tuples * 32 / 1e9:.4f} GB if "
              f"each tuple fetches one)", flush=True)
        for name, ms in times.items():
            same = ("within 1e-6 of plain (another order)" if name in
                    dict(others) else "bitwise equal to plain")
            print(f"  {name}: {ms} ms, {same}", flush=True)
        del means_t, want

    (PROBE_BUILD / "small_kernel_probe.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
