#!/usr/bin/env python3
"""The flash_attention backward kernel against other revisions of it,
under one timer.

    python3 scripts/flash_bwd_probe.py [--other PATH/flash_attention_bwd.cu ...]
                                       [--rounds R] [--seed S]

Needs one CUDA GPU (built for sm_90a).  At gemma3-1b's (BH 8, S 4096, hd
256) with windows 512 and -1, and at (32, 4096, 128) and (48, 4096, 64)
full causal, on unit-normal q, k, v, dO from ``--seed`` and the forward's
lse, it times this checkout's ``flash_attention_bwd_launch`` and the same
C entry point from every ``--other`` source (a
``csrc/flash_attention_bwd.cu`` of another revision or a variant, with
this revision's C interface) with ``chip_smoke.time_ms``, in ``--rounds``
rounds whose order alternates (this, other, ..., other, this).  Each
kernel's dq, dk, dv are held once against float64 autograd through the
plain version (max abs error printed).  Beside each time: the bound of
fp32 work on the CUDA cores and of split-TF32 work on the tensor cores
(``chip_smoke.flash_bwd_work``).  Prints the card's name and power limit
first, and a JSON object as the last line.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (_plain_attention_grads, flash_bwd_work,  # noqa: E402
                        time_ms)
from scripts.sketch_sim_probe import compile_all, smi  # noqa: E402

CASES = [(8, 256, 512), (8, 256, -1), (32, 128, -1), (48, 64, -1)]
S = 4096


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
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kern

    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi("name,power.limit").splitlines()[0], flush=True)
    libs = {"this tree": kern.bwd_library()}
    for src, lib in compile_all(list(args.other)).items():
        fn = lib.flash_attention_bwd_launch
        fn.restype = _build.c_int
        fn.argtypes = kern._BWD_SIG["flash_attention_bwd_launch"][1]
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
        scratch = torch.empty((2, bh, S), device=dev)
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
        bound, tf32_bound, pairs = flash_bwd_work(bh, S, S, hd, window)
        for name in libs:
            ms = statistics.median(times[name])
            print(f"BH {bh} S {S} hd {hd} window {window} {name}: "
                  f"{ms:.3f} ms ({times[name]}); fp32 bound "
                  f"{bound[0]:.4f} ms ({bound[0] / ms:.1%}), TF32 "
                  f"{tf32_bound[0]:.4f}; max abs err dq, dk, dv against "
                  f"float64 {errs[name]}", flush=True)
            result.append(dict(bh=bh, hd=hd, window=window, source=name,
                               ms=ms, times=times[name], bound_ms=bound[0],
                               errs=errs[name]))
        del q, k, v, do, o, want, outs
        torch.cuda.empty_cache()
    print(json.dumps({"flash_bwd_probe": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
