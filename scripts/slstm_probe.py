#!/usr/bin/env python3
"""slstm_scan and its backward against other revisions of them, under one
timer, and where their time goes.

    python3 scripts/slstm_probe.py [--other PATH/slstm_scan.cu ...]
                                   [--other-bwd PATH/slstm_scan_bwd.cu ...]
                                   [--only fwd|bwd] [--seed S]

Another revision's source comes from git, into the ignored build
directory, e.g. the parent's:

    mkdir -p build/probe/parent
    git show HEAD~1:src/repro_torch/csrc/slstm_scan.cu \\
        > build/probe/parent/slstm_scan.cu

(a backward source that includes ``slstm_scan.cu`` needs that file of its
own revision beside it).

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

The backward (``--only bwd`` skips the above), at xlstm-125m's training
shape (B 2, S 4,096, D 768, from the zero state) on seeded gates and
adjoints:

- this checkout's ``kern.launch_bwd`` and every ``--other-bwd`` source
  (the C interface ``slstm_scan_bwd_launch(gates, c0, n0, m0, dhs, dc,
  dn, dm, B, S, D, states, dgates, dc0, dn0, dm0, stream)``, e.g. the
  parent's thread-a-channel walk), and copies of this checkout's source at
  other geometries (``BWD_GEOMETRIES``, ``BWD_AHEAD``), each held bit for
  bit against ``ref.slstm_scan_bwd``, then timed back to back in turns
  other, this, this, other, and in a CUDA graph;
- cuts of this checkout's source (``BWD_CUTS``): its two launches alone
  (the adjoints alone on the scratch the whole ran filled, held bit for
  bit), and within the adjoints' launch the workers alone, the copies
  alone and the chain warps alone (shared memory set to 1 first; answers
  not checked);
- each launch path forced at every S in ``BWD_CROSSOVER_S`` (B 4, D 768,
  a cached state), held bit for bit and timed in a CUDA graph;
- the adjoint chains' floor from ``scripts/slstm_floor.cu``: chain A's
  pair (gc, gn) and chain B's gm alone from registers over 4,096 steps.

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
BWD_SOURCE = SOURCE.with_name("slstm_scan_bwd.cu")
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


# The backward's geometries (channels a block, warps a block, steps a
# tile) beside this checkout's, and its copies issued further ahead.
BWD_GEOMETRIES = {"6 warps": (12, 6, 64), "10 warps": (12, 10, 64),
                  "12 warps": (12, 12, 64), "14 warps": (12, 14, 64),
                  "tile 32": (12, 8, 32), "tile 48": (12, 8, 48)}
BWD_AHEAD = {"copies 3 tiles ahead": 3}
# Another variant of the backward's source: the chains' loop over a
# tile's blocks of kUnroll steps kept rolled.
BWD_ROLLED = {"chain blocks rolled": [
    ("#pragma unroll\n  for (int t0 = 0; t0 < kTile; t0 += kUnroll) {",
     "#pragma unroll 1\n  for (int t0 = 0; t0 < kTile; t0 += kUnroll) {")]}
# Cuts of the backward's source, as CUTS.
BWD_FILL = ("  a.S = S, a.D = D, a.d0 = d0, a.n_tiles = (S + kTile - 1) / "
            "kTile;\n",
            "  a.S = S, a.D = D, a.d0 = d0, a.n_tiles = (S + kTile - 1) / "
            "kTile;\n  for (int x = threadIdx.x; x < kFloats; x += kThreads) "
            "smem[x] = 1.0f;\n  __syncthreads();\n")
NO_STATES = ("  slstm_states_kernel<<<", "  if (S < 0) slstm_states_kernel<<<")
NO_ADJOINTS = ("  bwd::slstm_bwd_tiles_kernel<<<",
               "  if (S < 0) bwd::slstm_bwd_tiles_kernel<<<")
BWD_CHAINS = [("const int n_a = a.steps(p - 1);", "const int n_a = 0;"),
              ("const int n_b = a.steps(p - 3);", "const int n_b = 0;")]
BWD_STAGES = ("const int n1 = a.steps(p), n2 = a.steps(p - 2), "
              "n3 = a.steps(p - 4);", "const int n1 = 0, n2 = 0, n3 = 0;")
# no copies: none issued and none waited for
BWD_COPIES = [("      if (a.steps(kq)) {\n", "      if (S < 0) {\n"),
              ("      if (vec && a.steps(p))\n        mbar_wait(",
               "      if (S < 0)\n        mbar_wait(")]
BWD_CUTS = {"adjoints alone": [NO_STATES],
            "forward again alone": [NO_ADJOINTS],
            "adjoint workers alone": [NO_STATES, BWD_FILL, *BWD_CHAINS],
            "adjoint workers alone, no copies": [NO_STATES, BWD_FILL,
                                                 *BWD_CHAINS, *BWD_COPIES],
            "adjoint copies alone": [NO_STATES, BWD_FILL, *BWD_CHAINS,
                                     BWD_STAGES],
            "adjoint chains alone": [NO_STATES, BWD_FILL, BWD_STAGES],
            "adjoint chains alone, no copies": [NO_STATES, BWD_FILL,
                                                BWD_STAGES, *BWD_COPIES]}
BWD_PATHS = {"bwd tiles only": "0", "bwd walk only": "1 << 30"}
BWD_CROSSOVER_S = (16, 32, 48, 64, 96, 128, 256)


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


def edited_bwd_sources(kern) -> dict[str, Path]:
    """{name: path} of this checkout's backward source at each other
    geometry, with each cut made and each path forced, every one beside a
    copy of this checkout's slstm_scan.cu (which it includes)."""
    src = BWD_SOURCE.read_text()
    edits = {name: [(f"constexpr int {k} = {old};",
                     f"constexpr int {k} = {new};")
                    for k, old, new in (("kChannels", kern.BWD_CHANNELS, c),
                                        ("kWarps", kern.BWD_WARPS, w),
                                        ("kTile", kern.BWD_TILE, t))]
             for name, (c, w, t) in BWD_GEOMETRIES.items()}
    ahead = re.search(r"constexpr int kAhead = \d+;", src).group(0)
    edits.update({name: [(ahead, f"constexpr int kAhead = {n};")]
                  for name, n in BWD_AHEAD.items()})
    edits.update(BWD_ROLLED)
    walk = f"constexpr int kWalkBelow = {kern.BWD_WALK_BELOW};"
    edits.update({name: [(walk, f"constexpr int kWalkBelow = {below};")]
                  for name, below in BWD_PATHS.items()})
    edits.update(BWD_CUTS)
    out = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"slstm_probe: {old.strip()!r} is not in "
                                 f"csrc/slstm_scan_bwd.cu")
            text = text.replace(old, new)
        path = (PROBE_BUILD / ("bwd_" + name.replace(",", "").replace(
            " ", "_")) / "slstm_scan_bwd.cu")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        (path.parent / "slstm_scan.cu").write_text(SOURCE.read_text())
        out[name] = path
    return out


def bwd_launch(torch, lib, label: str, shape, states=None):
    """run(gates, c0, n0, m0, dhs, dc, dn, dm) -> (dgates, dc0, dn0, dm0)
    through a library's ``slstm_scan_bwd_launch``, into outputs allocated
    once for ``shape`` (reused by the next call) and the (3, B, S, D)
    scratch ``states`` (a new one if None)."""
    f = lib.slstm_scan_bwd_launch
    f.restype = _I
    f.argtypes = [_P] * 8 + [_I] * 3 + [_P] * 6
    b, s, d = shape
    dev = torch.device("cuda")
    if states is None:
        states = torch.empty((3, b, s, d), device=dev)
    outs = (torch.empty((b, s, 4 * d), device=dev),
            *(torch.empty((b, d), device=dev) for _ in range(3)))

    def run(*xs):
        rc = f(*(x.data_ptr() for x in xs), b, s, d, states.data_ptr(),
               *(o.data_ptr() for o in outs),
               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{label}: slstm_scan_bwd launch error {rc}")
        return outs

    return run


def adjoint_floor_ms(torch, lib, groups: int, steps: int, gen) -> dict:
    """The adjoint chains' floor, chain A's pair and chain B alone, over
    ``steps`` steps at ``groups`` warps, back to back and in a graph."""
    f = lib.slstm_adjoint_floor_launch
    f.restype = _I
    f.argtypes = [_P, _I, _I, _I, _P, _P]
    lib.slstm_floor_unroll.restype = _I
    u = lib.slstm_floor_unroll()
    dev = torch.device("cuda")
    seed = torch.rand((3, u, 32), generator=gen, device=dev)
    seed[2] *= 0.9          # f_e (chain A) or w (chain B) below 1: bounded
    out = torch.empty((2 * 32 * groups,), device=dev)
    result = {"groups": groups, "steps": steps}
    for name, pair in (("gc_gn", 1), ("gm", 0)):
        def run(pair=pair):
            rc = f(seed.data_ptr(), groups, steps, pair, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"adjoint floor: launch error {rc}")

        run()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise SystemExit("adjoint floor: chains not finite")
        ms = time_ms(torch, run)
        result[name] = {"ms": ms, "graph_ms": graph_ms(torch, run, calls=20),
                        "ns_per_step": ms * 1e6 / steps}
    return result


def bwd_inputs(torch, shape, cached: bool, gen):
    b, s, d = shape
    dev = torch.device("cuda")
    gates, state = inputs(torch, shape, cached, gen)
    adj = (torch.randn((b, s, d), generator=gen, device=dev),
           *(torch.randn((b, d), generator=gen, device=dev)
             for _ in range(3)))
    return (gates, *state, *adj)


def probe_bwd(torch, args, gen) -> dict:
    """The backward's section; see the module's docstring."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import slstm_scan as kern

    edited = edited_bwd_sources(kern)
    libs = compile_all([FLOOR_SOURCE, *args.other_bwd, *edited.values()])
    smem, per_sm = kern.bwd_resources()
    own = _build.load("slstm_scan_bwd", kern._BWD_SIG)
    report = _build.ptxas_report("slstm_scan_bwd")
    print(f"bwd this: {kern.BWD_CHANNELS} channels, {kern.BWD_WARPS} warps, "
          f"tile {kern.BWD_TILE}, walk below {kern.BWD_WALK_BELOW}; {smem} B "
          f"of shared memory a block, {per_sm} block(s) an SM; ptxas "
          f"{report}", flush=True)
    shape = PREFILL
    b, s, d = shape
    fns = {str(p): bwd_launch(torch, libs[p], str(p), shape)
           for p in args.other_bwd}
    # the cuts share this checkout's scratch, which its runs fill with
    # the states: the adjoints alone then answer as the whole does
    states = torch.empty((3, b, s, d), device="cuda")
    fns["this"] = bwd_launch(torch, own, "this", shape, states)
    fns.update({name: bwd_launch(torch, libs[edited[name]], name, shape)
                for name in edited if name not in BWD_CUTS
                and name not in BWD_PATHS})
    cuts = {name: bwd_launch(torch, libs[edited[name]], name, shape, states)
            for name in BWD_CUTS}
    xs = bwd_inputs(torch, shape, False, gen)
    want = ref.slstm_scan_bwd(*xs)
    for label, fn in fns.items():
        got = fn(*xs)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"bwd {label}: differs from the plain version")
    first = [t.clone() for t in fns["this"](*xs)]
    if not all(torch.equal(g, w) for g, w in zip(fns["this"](*xs), first)):
        raise SystemExit("bwd this: two runs differ")
    got = cuts["adjoints alone"](*xs)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("bwd adjoints alone: differs from the plain version")
    del first, got
    n_bytes = 4 * b * s * 9 * d + 4 * 10 * b * d
    case = {"shape": shape, "ms": {}, "graph_ms": {},
            "bound_ms": bound_ms(n_bytes, 45 * b * s * d)[0],
            "smem_bytes": smem, "blocks_per_sm": per_sm,
            "ptxas": report}
    others = [str(p) for p in args.other_bwd]
    turns = others + ["this", "this"] + others + [
        name for name in edited if name not in BWD_CUTS
        and name not in BWD_PATHS]
    for label in turns:
        case["ms"].setdefault(label, []).append(
            time_ms(torch, lambda fn=fns[label]: fn(*xs)))
    for label, fn in fns.items():
        case["graph_ms"][label] = graph_ms(torch, lambda fn=fn: fn(*xs),
                                           calls=10)
    case["cut_graph_ms"] = {
        name: graph_ms(torch, lambda fn=fn: fn(*xs), calls=10)
        for name, fn in cuts.items()}
    print(f"bwd (B {b}, S {s}, D {d}): bound {case['bound_ms']:.4f} ms; "
          f"cuts in a graph, ms: {case['cut_graph_ms']}", flush=True)
    for label in fns:
        print(f"  {label}: {case['ms'][label]} ms back to back, "
              f"{case['graph_ms'][label]:.4f} ms in a graph, bit for bit "
              f"with plain", flush=True)
    out = {"train": case, "crossover_graph_ms": {}}
    paths = {name: libs[edited[name]] for name in BWD_PATHS}
    for s2 in BWD_CROSSOVER_S:
        sh = (DECODE[0], s2, DECODE[2])
        xs2 = bwd_inputs(torch, sh, True, gen)
        want2 = ref.slstm_scan_bwd(*xs2)
        row = {}
        for name, lib in paths.items():
            fn = bwd_launch(torch, lib, name, sh)
            got = fn(*xs2)
            if not all(torch.equal(g, w) for g, w in zip(got, want2)):
                raise SystemExit(f"{name} at S {s2}: differs from the plain "
                                 f"version")
            row[name] = graph_ms(torch, lambda fn=fn: fn(*xs2), calls=10)
        out["crossover_graph_ms"][s2] = row
        print(f"bwd crossover (B {sh[0]}, S {s2}, D {sh[2]}), ms in a graph, "
              f"bit for bit with plain: {row}", flush=True)
    out["adjoint_floor"] = floor = adjoint_floor_ms(
        torch, libs[FLOOR_SOURCE], b * d // 32, s, gen)
    print(f"adjoint chain floor ({floor['groups']} groups of 32, {s} steps): "
          f"gc, gn {floor['gc_gn']['ns_per_step']:.2f} ns a step, gm "
          f"{floor['gm']['ns_per_step']:.2f} ns a step", flush=True)
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


def probe_fwd(torch, args, gen) -> dict:
    """The forward's section; see the module's docstring."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import slstm_scan as kern

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
    result = {"geometry": {
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
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/slstm_scan.cu")
    ap.add_argument("--other-bwd", type=Path, action="append", default=[],
                    help="another revision's csrc/slstm_scan_bwd.cu")
    ap.add_argument("--only", choices=("fwd", "bwd"), default=None,
                    help="run only the forward's or the backward's section")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("slstm_probe: no CUDA device", file=sys.stderr)
        return 1
    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card}
    if args.only != "bwd":
        result.update(probe_fwd(torch, args, gen))
    if args.only != "fwd":
        result["bwd"] = probe_bwd(torch, args, gen)
    out = PROBE_BUILD / "slstm_probe.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
