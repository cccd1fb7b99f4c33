#!/usr/bin/env python3
"""slstm_scan against another revision of it, under one timer, and where
its time goes.

    python3 scripts/slstm_probe.py [--other PATH/slstm_scan.cu ...]
                                   [--seed S]

Another revision's source comes from git, into the ignored build
directory, e.g. the parent's:

    mkdir -p build/probe/parent
    git show HEAD~1:src/repro_torch/csrc/slstm_scan.cu \\
        > build/probe/parent/slstm_scan.cu

Needs one CUDA GPU (built for sm_90a).  At xlstm-125m's prefill shape (B 2,
S 4,096, D 768, from c = n = 0, m = -1e30) and its decode step (B 4, S 1,
D 768, from a seeded state), on seeded gates:

- this checkout's kernel and every ``--other`` source (the same C
  interface, ``slstm_scan_launch(gates, c0, n0, m0, B, S, D, hs, c, n, m,
  stream)``), and copies of this checkout's source at other geometries
  (``GEOMETRIES``: 32 or 16 channels a block, 8 or 16 warps a block;
  ``AHEAD``: the gates' copies issued 3 or 4 tiles ahead),
  each held bit for bit against the plain version ``ref.slstm_scan`` in
  hs, c, n and m, then timed with ``chip_smoke.time_ms`` (calls back to
  back) in turns other, this, this, other, and in a CUDA graph
  (``chip_smoke.graph_ms``: device time without the host's launch path);
- cuts of this checkout's source (``CUTS``, shared memory set to 1 first,
  since zeros would send the IEEE quotients down their slow path; the
  answers not checked): the workers alone (the chain warps idle), with
  and without their gate copies, the copies alone, and the chain warps
  alone (the workers only copy the gates in, or not even that), which
  says what sets the time;
- each launch path forced at every S (``PATHS``: the tiles only, the walk
  of a thread a channel only) at B 4, D 768 and S in ``CROSSOVER_S``, held
  bit for bit and timed in a CUDA graph: where the walk should stop;
- the chain floor, ``scripts/slstm_floor.cu``: the carried chains alone
  from registers, 48 channel groups of 32 over 4,096 steps, the least any
  design keeping the sequential rounded order can take.

Prints the card's name and power limit first and a JSON object as the
last line (also written to build/probe/slstm_probe.json).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import bound_ms, graph_ms, time_ms  # noqa: E402
from scripts.sketch_sim_probe import (PROBE_BUILD, compile_all,  # noqa: E402
                                     smi)

_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "slstm_scan.cu"
FLOOR_SOURCE = ROOT / "scripts" / "slstm_floor.cu"
PREFILL = (2, 4096, 768)
DECODE = (4, 1, 768)
# Geometries (channels a block, warps a block, steps a tile) timed beside
# this checkout's, as copies of its source with the three constants
# replaced.  Each keeps its workers' rows a tile a whole number.
GEOMETRIES = {"32 channels, 8 warps": (32, 8, 48), "16 channels": (16, 12, 80),
              "16 channels, 8 warps": (16, 8, 96), "16 warps": (12, 16, 112)}
# Cuts of this checkout's source for the time breakdown: each (text,
# replacement) must match the source, or the probe stops.  Shared memory
# is set to 1 first: zeros would send the IEEE quotients down their slow
# path.
FILL = ("  a.n_tiles = (S + kTile - 1) / kTile;\n",
        "  a.n_tiles = (S + kTile - 1) / kTile;\n"
        "  for (int x = threadIdx.x; x < kFloats; x += kThreads) "
        "smem[x] = 1.0f;\n  __syncthreads();\n")
CHAINS = [("const int n_m = a.steps(p);", "const int n_m = 0;"),
          ("const int n_cn = a.steps(p - 2);", "const int n_cn = 0;")]
STAGES = ("const int ne = a.steps(p - 1), no = a.steps(p - 3);",
          "const int ne = 0, no = 0;")
COPIES = [("      if (a.steps(kz)) {\n", "      if (S < 0) {\n"),
          ("      if (a.steps(ko)) {\n", "      if (S < 0) {\n")]
CUTS = {"workers alone": [FILL, *CHAINS],
        "workers alone, no copies": [FILL, *CHAINS, *COPIES],
        "copies alone": [FILL, *CHAINS, STAGES],
        "chains alone": [FILL, STAGES],
        "chains alone, no copies": [FILL, STAGES, *COPIES]}
# The gates' copies issued further ahead than this checkout's kAhead.
AHEAD = {"copies 3 tiles ahead": 3, "copies 4 tiles ahead": 4}
# Each launch path forced at every S, for the crossover: the tiles, and the
# walk of a thread a channel that launches below kWalkBelow steps.
PATHS = {"tiles only": "0", "walk only": "1 << 30"}
CROSSOVER_S = (1, 16, 32, 48, 64, 80, 96, 128)


def geometry_edits(kern, channels: int, warps: int, tile: int) -> list:
    return [(f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")
            for name, old, new in (("kChannels", kern.CHANNELS, channels),
                                   ("kWarps", kern.WARPS, warps),
                                   ("kTile", kern.TILE, tile))]


def edited_sources(kern) -> dict[str, Path]:
    """{name: path} of this checkout's source at each other geometry and
    with each cut made, in the probe's build directory."""
    src = SOURCE.read_text()
    edits = {name: geometry_edits(kern, *g) for name, g in GEOMETRIES.items()
             if g != (kern.CHANNELS, kern.WARPS, kern.TILE)}
    ahead = re.search(r"constexpr int kAhead = \d+;", src).group(0)
    edits.update({name: [(ahead, f"constexpr int kAhead = {n};")]
                  for name, n in AHEAD.items()})
    walk = f"constexpr int kWalkBelow = {kern.WALK_BELOW};"
    paths = {name: [(walk, f"constexpr int kWalkBelow = {below};")]
             for name, below in PATHS.items()}
    out = {}
    for name, pairs in {**edits, **CUTS, **paths}.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"slstm_probe: {old.strip()!r} is not in "
                                 f"csrc/slstm_scan.cu")
            text = text.replace(old, new)
        path = (PROBE_BUILD / name.replace(",", "").replace(" ", "_")
                / "slstm_scan.cu")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out[name] = path
    return out


def scan_launch(torch, lib, label: str):
    """run(gates, c0, n0, m0) -> (hs, c, n, m) through a library's
    ``slstm_scan_launch``, on new outputs as ``ops.slstm_scan`` allocates."""
    f = lib.slstm_scan_launch
    f.restype = _I
    f.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 5

    def run(gates, c0, n0, m0):
        b, s, d4 = gates.shape
        hs = torch.empty((b, s, d4 // 4), dtype=torch.float32,
                         device=gates.device)
        c, n, m = (torch.empty_like(c0) for _ in range(3))
        rc = f(gates.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
               b, s, d4 // 4, hs.data_ptr(), c.data_ptr(), n.data_ptr(),
               m.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{label}: slstm_scan launch error {rc}")
        return hs, c, n, m

    return run


def inputs(torch, shape, cached: bool, gen):
    b, s, d = shape
    dev = torch.device("cuda")
    gates = torch.randn((b, s, 4 * d), generator=gen, device=dev)
    if cached:
        state = (torch.randn((b, d), generator=gen, device=dev),
                 torch.rand((b, d), generator=gen, device=dev) * 4 + 0.5,
                 torch.randn((b, d), generator=gen, device=dev) * 3)
    else:
        zero = torch.zeros((b, d), device=dev)
        state = (zero, zero.clone(), torch.full((b, d), -1e30, device=dev))
    return gates, state


def floor_ms(torch, lib, groups: int, steps: int, gen) -> dict:
    """The chain floor kernel's time over ``steps`` steps at ``groups``
    warps, back to back and in a CUDA graph."""
    f = lib.slstm_floor_launch
    f.restype = _I
    f.argtypes = [_P, _I, _I, _P, _P]
    lib.slstm_floor_unroll.restype = _I
    lib.slstm_floor_unroll.argtypes = []
    u = lib.slstm_floor_unroll()
    dev = torch.device("cuda")
    seed = torch.rand((5, u, 32), generator=gen, device=dev)
    seed[0] -= 1.0          # f in [-1, 0): m settles near max(i)
    seed[2] *= 0.9          # f_e in [0, 0.9): c and n stay bounded
    out = torch.empty((3 * 32 * groups,), device=dev)

    def run():
        rc = f(seed.data_ptr(), groups, steps, out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"chain floor: launch error {rc}")

    run()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("chain floor: state not finite")
    ms = time_ms(torch, run)
    return {"groups": groups, "steps": steps, "ms": ms,
            "graph_ms": graph_ms(torch, run, calls=20),
            "ns_per_step": ms * 1e6 / steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/slstm_scan.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("slstm_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import slstm_scan as kern

    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    edited = edited_sources(kern)
    libs = compile_all([FLOOR_SOURCE, *args.other, *edited.values()])
    smem, per_sm = kern.resources()
    own = _build.load("slstm_scan", kern._SIG)
    print(f"this: {kern.CHANNELS} channels, {kern.WARPS} warps, tile "
          f"{kern.TILE}; {smem} B of shared memory a block, {per_sm} "
          f"block(s) an SM; ptxas {_build.ptxas_report('slstm_scan')}",
          flush=True)
    others = {str(p): scan_launch(torch, libs[p], str(p)) for p in args.other}
    this = scan_launch(torch, own, "this")
    variants = {name: scan_launch(torch, libs[edited[name]], name)
                for name in edited if name not in CUTS and name not in PATHS}
    cuts = {name: scan_launch(torch, libs[edited[name]], name)
            for name in CUTS}
    paths = {name: scan_launch(torch, libs[edited[name]], name)
             for name in PATHS}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card, "geometry": {
        "channels": kern.CHANNELS, "warps": kern.WARPS, "tile": kern.TILE,
        "smem_bytes": smem, "blocks_per_sm": per_sm}, "cases": {}}
    for what, shape, cached in (("prefill", PREFILL, False),
                                ("decode step", DECODE, True)):
        b, s, d = shape
        gates, state = inputs(torch, shape, cached, gen)
        want = ref.slstm_scan(gates, *state)
        fns = {**others, "this": this, **variants}
        for label, fn in fns.items():
            got = fn(gates, *state)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"{label} {what}: differs from the plain "
                                 f"version")
        case = {"shape": shape, "ms": {}, "graph_ms": {},
                "bound_ms": bound_ms(20 * b * s * d + 24 * b * d,
                                     19 * b * s * d)[0]}
        turns = list(others) + ["this", "this"] + list(others) + list(
            variants)
        for label in turns:
            case["ms"].setdefault(label, []).append(
                time_ms(torch, lambda fn=fns[label]: fn(gates, *state)))
        for label, fn in fns.items():
            case["graph_ms"][label] = graph_ms(
                torch, lambda fn=fn: fn(gates, *state), calls=20)
        if s >= kern.WALK_BELOW:
            case["cut_graph_ms"] = {
                name: graph_ms(torch, lambda fn=fn: fn(gates, *state),
                               calls=20)
                for name, fn in cuts.items()}
        result["cases"][what] = case
        print(f"{what} (B {b}, S {s}, D {d}): bound {case['bound_ms']:.4f} "
              f"ms; cuts in a graph, ms: {case.get('cut_graph_ms')}",
              flush=True)
        for label in fns:
            print(f"  {label}: {case['ms'][label]} ms back to back, "
                  f"{case['graph_ms'][label]:.4f} ms in a graph, bit for bit "
                  f"with plain", flush=True)
        del gates, state, want
    result["crossover_graph_ms"] = {}
    for s in CROSSOVER_S:
        b, d = DECODE[0], DECODE[2]
        gates, state = inputs(torch, (b, s, d), True, gen)
        want = ref.slstm_scan(gates, *state)
        row = {}
        for name, fn in paths.items():
            got = fn(gates, *state)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"{name} at S {s}: differs from the plain "
                                 f"version")
            row[name] = graph_ms(torch, lambda fn=fn: fn(gates, *state),
                                 calls=20)
        result["crossover_graph_ms"][s] = row
        print(f"crossover (B {b}, S {s}, D {d}), ms in a graph, bit for bit "
              f"with plain: {row}", flush=True)
    b, s, d = PREFILL
    floor = floor_ms(torch, libs[FLOOR_SOURCE], b * d // 32, s, gen)
    result["chain_floor"] = floor
    print(f"chain floor ({floor['groups']} groups of 32, {s} steps): "
          f"{floor['ms']:.4f} ms back to back, {floor['graph_ms']:.4f} ms in "
          f"a graph, {floor['ns_per_step']:.2f} ns a step", flush=True)
    out = PROBE_BUILD / "slstm_probe.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
