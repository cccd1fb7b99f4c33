#!/usr/bin/env python3
"""The flash_attention backward kernel against other revisions of it,
under one timer.

    python3 scripts/flash_bwd_probe.py [--other PATH/flash_attention_bwd.cu ...]
                                       [--rounds R] [--seed S]

Needs one CUDA GPU (built for sm_90a).  At gemma3-1b's (BH 8, S 4096, hd
256) with windows 512 and -1, and at (32, 4096, 128), (48, 4096, 64),
(32, 4096, 32) and (32, 4096, 16) full causal, on unit-normal q, k, v,
dO from ``--seed`` and the forward's lse, it times this checkout's
``flash_attention_bwd_launch`` and the same C entry point from every
``--other`` source (a
``csrc/flash_attention_bwd.cu`` of another revision or a variant, with
this revision's C interface) with ``chip_smoke.time_ms``, in ``--rounds``
rounds whose order alternates (this, other, ..., other, this).  One
scratch serves all: the largest any of them asks for
(``flash_attention_bwd_scratch_floats``; a source without that function
takes (2, BH, S) floats, each row's D and Z).  Each kernel's dq, dk, dv
are held once against float64 autograd through the plain version (max
abs error printed).  Beside each time: the bound of the arithmetic
the kernel runs at that hd, split-TF32 on the tensor cores or fp32 on the
CUDA cores, and the fp32 one (``chip_smoke.flash_bwd_work``), and this
checkout's device time by launch from one profiled run
(``torch.profiler``), each launch's share of the timed total beside it;
a profile that misses one of the launches is taken again, and after
three such it is printed as incomplete.  Prints the card's name and
power limit first, and a JSON object as the last line.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (_plain_attention_grads, flash_bwd_work,  # noqa: E402
                        time_ms)
from scripts.sketch_sim_probe import compile_all, smi  # noqa: E402

CASES = [(8, 256, 512), (8, 256, -1), (32, 128, -1), (48, 64, -1),
         (32, 32, -1), (32, 16, -1)]
S = 4096


def launch_split(torch, fn, names) -> tuple[dict, bool]:
    """Device ms of each flash_bwd_* kernel in one profiled run of fn
    (after one warm run), and whether every launch in ``names`` showed;
    up to three profiled runs until they all do."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or "flash_bwd" not in e.name:
                continue
            name = re.search(r"flash_bwd_\w+", e.name).group(0)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        if set(out) == set(names):
            return out, True
    return out, False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another flash_attention_bwd.cu to time too")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as kern

    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi("name,power.limit").splitlines()[0], flush=True)
    libs = {"this tree": kern.bwd_library()}
    for src, lib in compile_all(list(args.other)).items():
        for name in ("flash_attention_bwd_launch",
                     "flash_attention_bwd_scratch_floats"):
            if hasattr(lib, name):
                getattr(lib, name).restype = kern._BWD_SIG[name][0]
                getattr(lib, name).argtypes = kern._BWD_SIG[name][1]
        libs[str(src)] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    result = []
    for bh, hd, window in CASES:
        q, k, v, do = (torch.randn((bh, S, hd), generator=gen, device=dev)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(hd)
        o = torch.empty_like(q)
        lse = torch.empty((bh, S), device=dev)
        kern.launch(q, k, v, window, S, o, scale, lse)
        want = _plain_attention_grads(torch, q, k, v, do, window,
                                      torch.float64)
        outs = [torch.empty_like(q) for _ in range(3)]
        scratch = torch.empty(max(
            lib.flash_attention_bwd_scratch_floats(bh, S, S, window)
            if hasattr(lib, "flash_attention_bwd_scratch_floats")
            else 2 * bh * S for lib in libs.values()), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(lib):
            rc = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                do.data_ptr(), *(t.data_ptr() for t in outs),
                scratch.data_ptr(), bh, S, S, hd, S, window, scale, stream)
            if rc:
                raise RuntimeError(f"flash_attention_bwd_launch error {rc}")

        times = {name: [] for name in libs}
        errs = {}
        for name, lib in libs.items():
            run(lib)
            errs[name] = [float((g.double() - w).abs().max())
                          for g, w in zip(outs, want)]
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(time_ms(torch, lambda: run(libs[name])))
        split, whole = launch_split(torch, lambda: run(libs["this tree"]),
                                    kern.BWD_KERNELS)
        mine = statistics.median(times["this tree"])
        print(f"BH {bh} S {S} hd {hd} window {window} this tree by launch "
              f"(one profiled run, device ms, share of the timed "
              f"{mine:.3f} ms): "
              + ", ".join(f"{n} {split[n]:.3f} ({split[n] / mine:.1%})"
                          for n in kern.BWD_KERNELS if n in split)
              + ("" if whole else f"; INCOMPLETE: no "
                 f"{sorted(set(kern.BWD_KERNELS) - set(split))} in three "
                 f"profiled runs"), flush=True)
        bound, fp32_bound, pairs = flash_bwd_work(bh, S, S, hd, window)
        for name in libs:
            ms = statistics.median(times[name])
            print(f"BH {bh} S {S} hd {hd} window {window} {name}: "
                  f"{ms:.3f} ms ({times[name]}); bound {bound[0]:.4f} ms "
                  f"({bound[0] / ms:.1%}), fp32 bound {fp32_bound[0]:.4f} "
                  f"({fp32_bound[0] / ms:.1%}); max abs err dq, dk, dv "
                  f"against float64 {errs[name]}", flush=True)
            result.append(dict(bh=bh, hd=hd, window=window, source=name,
                               ms=ms, times=times[name], bound_ms=bound[0],
                               fp32_bound_ms=fp32_bound[0], errs=errs[name],
                               **({"by_launch": split,
                                   "by_launch_complete": whole}
                                  if name == "this tree" else {})))
        del q, k, v, do, o, want, outs
        torch.cuda.empty_cache()
    print(json.dumps({"flash_bwd_probe": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
