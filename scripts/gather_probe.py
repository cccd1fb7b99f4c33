#!/usr/bin/env python3
"""What holds the gather kernels back on the card, and how they compare
with another revision of them, under one timer.

    python3 scripts/gather_probe.py [--other PATH/gather.cu ...]
                                    [--n-docs N] [--seed S]

Needs one CUDA GPU (built for sm_90a).  On the batch that
``chip_smoke.py``'s kernel phase checks (the first 4,096 documents of the
NYT-width corpus of ``--n-docs`` documents, K 10,000, D 495,126, the
normalised cluster sums of a seeded random assignment as means, EstParams'
thresholds for them) it times, each with ``chip_smoke.time_ms`` and each
held bit for bit against its plain version on the card:

- this checkout's ``sparse_sim`` (no counts, as classify calls it),
  ``esicp_gather`` (with counts, as the fits call it) and the ``square``
  variant (on 1 at the tail slots, id >= t_th, as CS-ICP calls it, and
  at t_th 0, where the dead id-0 slots are live too and each row's id-0
  slots after its head are walked slot by slot);
- the same three from every ``--other`` source (a ``csrc/gather.cu`` of
  another revision, e.g. unpacked with ``git archive``; its entry points
  may lack the scratch argument, and its square variant may take none);
- ``torch.sparse.mm`` on the batch as CSR, the library yardstick;
- the hot-rows variant: the same values with every id folded onto the
  1,024 rows id mod 1,024 (each row's live slots re-sorted by id), rows
  that stay in L2 (1,024 × 40 KB), for every kernel above: its time is the
  L2/issue-limited time, and the gap to the real batch the cost of rows
  that miss L2;
- this checkout's kernel at its other tile settings (documents per tile
  Bt, columns per slab Kt, consumer warps; square has none), and at its
  own with the grid's column slabs fastest (setting 4) in place of its
  document tiles, to show what scheduling slabs slowest does for L2.

Beside each time: the means-row bytes the kernel moves to the SMs (one
K-row per live tuple for a tuple-by-tuple walk, one per distinct row of a
document tile for the tiled kernel) and the rate that makes.  Prints the
card's name and power limit first and a JSON object as the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (BATCH, NYT_K, NYT_NT_MEAN, NYT_VOCAB,  # noqa: E402
                        time_ms)
from repro_torch.tune.cost import tile_distinct  # noqa: E402
from scripts.sketch_sim_probe import compile_all, smi  # noqa: E402

HOT_ROWS = 1024


def corpus_batch(torch, n_docs: int, seed: int):
    """(ids, vals, means_t, t_th, v_th) as chip_smoke.kernel_phase makes
    them."""
    from repro_torch.core.estparams import estimate_params
    from repro_torch.core.meanindex import normalized_means
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.kernels import ops

    docs, _, _, _ = make_corpus(CorpusSpec(
        n_docs=n_docs, vocab=NYT_VOCAB, nt_mean=NYT_NT_MEAN, n_topics=100,
        seed=seed), device="cuda")
    dev, k = docs.device, NYT_K
    gen = torch.Generator(device=dev).manual_seed(seed)
    assign = torch.randint(0, k, (docs.n_docs,), generator=gen, device=dev,
                           dtype=torch.int32)
    assign[::97] = k
    lam = ops.segment_update(assign, docs, k=k)
    means_t = normalized_means(lam, lam)
    del lam
    vals_all = docs.live_vals()
    rho = ops.rho_gather(assign, docs.ids, vals_all, means_t)
    params, _ = estimate_params(docs, docs.df, means_t, rho, k=k)
    ids = docs.ids[:BATCH].contiguous()
    vals = docs.vals[:BATCH].contiguous()
    return ids, vals, means_t, params.t_th, params.v_th


def hot_rows(torch, ids, vals):
    """The same values on ids mod HOT_ROWS, each row's live slots sorted
    by the new id (stable), dead slots left at the end."""
    live = vals != 0
    folded = torch.where(live, ids % HOT_ROWS, torch.iinfo(torch.int32).max)
    order = torch.sort(folded, dim=1, stable=True).indices
    h_ids = torch.where(live, ids % HOT_ROWS, 0).gather(1, order)
    return h_ids.contiguous(), vals.gather(1, order).contiguous()


def other_gather(torch, lib, path: Path):
    """(sims(ids, vals, means_t), esicp(ids, vals, means_t, t_th, v_th),
    square(ids, vals, means_t)) from another revision's library, with or
    without the scratch argument."""
    from repro_torch.kernels.esicp_gather import ESICP, SIMS, SQUARE

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scratch_fn = getattr(lib, "gather_scratch_bytes", None)
    if scratch_fn is not None:
        scratch_fn.restype = ctypes.c_longlong
        scratch_fn.argtypes = [i] * 5
    extra = [p] if scratch_fn is not None else []
    lib.sparse_sim_launch.restype = i
    lib.sparse_sim_launch.argtypes = [p, p, p, i, i, i, i, i, p, p,
                                      *extra, p]
    lib.esicp_gather_launch.restype = i
    lib.esicp_gather_launch.argtypes = [p, p, p, i, i, i, i, f, f, p, p, p,
                                        p, *extra, p]

    def scratch(ids, d, mode):
        if scratch_fn is None:
            return []
        n = scratch_fn(ids.shape[0], ids.shape[1], d, mode, 0)
        if n < 0:                          # a mode that takes no plan
            return [None]
        return [torch.empty((n,), dtype=torch.uint8,
                            device=ids.device).data_ptr()]

    def sims(ids, vals, means_t, square=0):
        b, pw = ids.shape
        d, k = means_t.shape
        out = torch.empty((b, k), device=ids.device)
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        rc = lib.sparse_sim_launch(ids.data_ptr(), vals.data_ptr(),
                                   means_t.data_ptr(), b, pw, d, k, square,
                                   out.data_ptr(), None,
                                   *scratch(ids, d, SQUARE if square
                                            else SIMS), stream)
        if rc:
            raise RuntimeError(f"{path}: sparse_sim launch error {rc}")
        return out

    def esicp(ids, vals, means_t, t_th, v_th):
        b, pw = ids.shape
        d, k = means_t.shape
        out = [torch.empty((b, k), device=ids.device) for _ in range(3)]
        cnt = torch.empty((b, k), dtype=torch.int32, device=ids.device)
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        rc = lib.esicp_gather_launch(
            ids.data_ptr(), vals.data_ptr(), means_t.data_ptr(), b, pw, d, k,
            float(t_th), float(v_th), *(o.data_ptr() for o in out),
            cnt.data_ptr(), *scratch(ids, d, ESICP), stream)
        if rc:
            raise RuntimeError(f"{path}: esicp_gather launch error {rc}")
        return (*out, cnt)

    return sims, esicp, lambda ids, vals, m: sims(ids, vals, m, square=1)


def setting_gather(torch, lib, setting: int):
    """This checkout's kernel at tile setting ``setting``: (sims, esicp,
    square)."""
    from repro_torch.kernels.esicp_gather import ESICP, SIMS, SQUARE, scratch

    def run(mode, ids, vals, means_t, t_th, v_th):
        b, pw = ids.shape
        d, k = means_t.shape
        out = [torch.empty((b, k), device=ids.device) for _ in range(3)]
        cnt = (torch.empty((b, k), dtype=torch.int32, device=ids.device)
               if mode == ESICP else None)
        rc = lib.gather_setting_launch(
            mode, setting, ids.data_ptr(), vals.data_ptr(),
            means_t.data_ptr(), b, pw, d, k, float(t_th), float(v_th), None,
            *(o.data_ptr() for o in out),
            None if cnt is None else cnt.data_ptr(),
            scratch(lib, ids, d, mode, setting).data_ptr(),
            torch.cuda.current_stream(ids.device).cuda_stream)
        if rc:
            raise RuntimeError(f"setting {setting}: launch error {rc}")
        return (*out, cnt) if mode == ESICP else out[2]

    return (lambda ids, vals, m: run(SIMS, ids, vals, m, 0.0, 0.0),
            lambda ids, vals, m, t, v: run(ESICP, ids, vals, m, t, v),
            lambda ids, vals, m: run(SQUARE, ids, vals, m, 0.0, 0.0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/gather.cu to time too")
    ap.add_argument("--n-docs", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import esicp_gather as kern, ops, ref

    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    libs = compile_all(list(args.other))
    lib = kern.library()
    ids, vals, means_t, t_th, v_th = corpus_batch(torch, args.n_docs,
                                                  args.seed)
    occupancy = {f"{name} setting {setting}": lib.gather_blocks_per_sm(
        mode, setting, counts) for name, mode, counts in (
            ("sparse_sim", kern.SIMS, 0), ("square", kern.SQUARE, 0),
            ("esicp_gather", kern.ESICP, 1))
        for setting in range(4) if lib.gather_tile_docs(mode, setting) > 0}
    occupancy.update({"sparse_sim counts setting 0": lib.gather_blocks_per_sm(
        kern.SIMS, 0, 1), "ta setting 0": lib.gather_blocks_per_sm(
            kern.TA, 0, 1)})
    print("blocks per SM: " + ", ".join(f"{k} {v}"
                                        for k, v in occupancy.items()),
          flush=True)
    d, k = means_t.shape
    row = k * 4
    result = {"card": card, "shape": [BATCH, ids.shape[1], d, k],
              "t_th": t_th, "v_th": v_th, "blocks_per_sm": occupancy}
    tail = (ids >= t_th).to(torch.float32)
    batches = {"real": (ids, vals), "hot": hot_rows(torch, ids, vals),
               "tail": (ids, tail), "hot tail": hot_rows(torch, ids, tail),
               "tail at t_th 0": (ids, (ids >= 0).to(torch.float32))}
    tiles = {BATCH, *(lib.gather_tile_docs(m, setting)
                      for m in (kern.SIMS, kern.SQUARE, kern.ESICP)
                      for setting in range(4))} - {-1}
    for name, (bi, bv) in batches.items():
        live = bv != 0
        moved = {bt: tile_distinct(bi, live, d, bt) * row
                 for bt in sorted(tiles)}
        result[name] = {"tuples": int(live.sum()),
                        "walk_bytes": int(live.sum()) * row,
                        "tile_bytes": {str(bt): v for bt, v in moved.items()}}
        print(f"{name} batch: {int(live.sum())} live tuples; means rows "
              f"moved by a tuple walk {int(live.sum()) * row / 1e9:.3f} GB, "
              "by tiles of Bt documents: "
              + ", ".join(f"{bt} {v / 1e9:.3f} GB" for bt, v in moved.items()),
              flush=True)

    want = {}
    for name, (bi, bv) in batches.items():
        if "tail" in name:
            want[name] = ref.sparse_sim(bi, bv, means_t, square=True)[0]
        else:
            want[name] = (ref.sparse_sim(bi, bv, means_t)[0],
                          ref.esicp_gather(bi, bv, means_t, t_th, v_th,
                                           with_counts=True))

    def measure(label, fn, batch, exact, moved_bytes):
        bi, bv = batches[batch]
        got = fn(bi, bv)
        torch.cuda.synchronize()
        if exact is not None:
            got = got if isinstance(got, tuple) else (got,)
            exact = exact if isinstance(exact, tuple) else (exact,)
            if not all(torch.equal(g, w) for g, w in zip(got, exact)):
                raise SystemExit(f"{label}: differs from the plain version")
        del got
        ms = time_ms(torch, lambda: fn(bi, bv))
        r = {"ms": ms, "moved_bytes": moved_bytes,
             "TB_per_s": None if moved_bytes is None
             else moved_bytes / ms / 1e9}
        print(f"{label} [{batch}]: {ms:.4f} ms"
              + ("" if moved_bytes is None else
                 f", {moved_bytes / 1e9:.3f} GB of means rows at "
                 f"{r['TB_per_s']:.3f} TB/s")
              + ("" if exact is None else ", bitwise equal to plain"),
              flush=True)
        result.setdefault(label, {})[batch] = r

    modes = (kern.SIMS, kern.ESICP, kern.SQUARE)

    def kernels():
        """(label, {mode: documents per tile or None for a walk},
        {mode: fn(ids, vals)})."""
        yield ("(this tree)", {m: lib.gather_tile_docs(m, 0) for m in modes},
               {kern.SIMS: lambda i, v: ops.sparse_sim(i, v, means_t)[0],
                kern.ESICP: lambda i, v: ops.esicp_gather(
                    i, v, means_t, t_th, v_th, with_counts=True),
                kern.SQUARE: lambda i, v: ops.sparse_sim(
                    i, v, means_t, square=True)[0]})
        for src in args.other:
            sims, esicp, square = other_gather(torch, libs[src], src)
            tiled = getattr(libs[src], "gather_tile_docs", None)
            bt = {m: None for m in modes}
            if tiled is not None:
                tiled.restype = ctypes.c_int
                tiled.argtypes = [ctypes.c_int, ctypes.c_int]
                bt = {m: (tiled(m, 0) if tiled(m, 0) > 0 else None)
                      for m in modes}
            yield (f"({src})", bt,
                   {kern.SIMS: lambda i, v, f=sims: f(i, v, means_t),
                    kern.ESICP: lambda i, v, f=esicp: f(i, v, means_t, t_th,
                                                       v_th),
                    kern.SQUARE: lambda i, v, f=square: f(i, v, means_t)})
        for setting in (1, 2, 3, 4):
            sims, esicp, square = setting_gather(torch, lib, setting)
            bt = {m: lib.gather_tile_docs(m, setting) for m in modes}
            fns = {kern.SIMS: lambda i, v, f=sims: f(i, v, means_t),
                   kern.ESICP: lambda i, v, f=esicp: f(i, v, means_t, t_th,
                                                      v_th),
                   kern.SQUARE: lambda i, v, f=square: f(i, v, means_t)}
            yield (f"(setting {setting})", bt,
                   {m: f for m, f in fns.items() if bt[m] > 0})

    names = {kern.SIMS: "sparse_sim", kern.ESICP: "esicp_gather",
             kern.SQUARE: "square"}
    for label, bts, fns in kernels():
        for batch in batches:
            info = result[batch]
            for mode, fn in fns.items():
                if (mode == kern.SQUARE) != ("tail" in batch):
                    continue
                moved = (info["walk_bytes"] if bts[mode] is None
                         else info["tile_bytes"].get(str(bts[mode])))
                exact = (want[batch] if mode == kern.SQUARE else
                         want[batch][0 if mode == kern.SIMS else 1])
                measure(f"{names[mode]} {label}", fn, batch, exact, moved)

    for batch, (bi, bv) in batches.items():
        if "tail" in batch:
            continue
        live = bv != 0
        with warnings.catch_warnings():   # CSR support is marked beta
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_csr_tensor(
                torch.cat([torch.zeros(1, dtype=torch.int64, device=bi.device),
                           live.sum(1).cumsum(0)]),
                bi[live].long(), bv[live], size=(bi.shape[0], d),
                check_invariants=False)
        measure("torch.sparse.mm", lambda i, v, c=csr: torch.sparse.mm(
            c, means_t), batch, None, result[batch]["walk_bytes"])
    result["clocks_sm_now_max"] = smi("clocks.sm,clocks.max.sm")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
