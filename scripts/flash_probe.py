#!/usr/bin/env python3
"""The flash_attention kernel against another revision of it, under one
timer.

    python3 scripts/flash_probe.py [--other PATH/flash_attention.cu ...]
                                   [--rounds R] [--hd HD ...] [--seed S]

Needs one CUDA GPU (built for sm_90a).  At BH 8, S 4096 and hd 256 (the
gemma3-1b prefill's shape), and at hd 64 and 128, each with windows -1
(full causal) and 512, on unit-normal q, k, v from ``--seed``, it times

- this checkout's ``ops.flash_attention``;
- the same C entry point from every ``--other`` source (a
  ``csrc/flash_attention.cu`` of another revision, e.g. unpacked with
  ``git archive``): ``flash_attention_lse_launch`` with no lse, or
  ``flash_attention_launch`` in a revision older than the lse output;
- ``scaled_dot_product_attention`` in float32 (no TF32), the library
  yardstick;

with ``chip_smoke.time_ms`` (calls back to back, about 2 ms per rep), in
``--rounds`` rounds whose order alternates (this, other, ..., other, this),
each kernel held once against the plain version within 2e-5 rtol/atol.
Before the timings, the accuracy: at BH 2, S 1024, hd 64 and 256, full
causal, with q and k as drawn and scaled by 6 (scores ≈ 30), the max abs
error of each kernel and of the float32 plain version against the plain
version in float64.
Beside each time: the bound of the split-TF32 work on the tensor cores
(3 TF32 products per operation at 495 TFLOP/s) and of fp32 work on the
CUDA cores (67 TFLOP/s), and the share of each.  Prints the card's name
and power limit first, each instantiation's registers and spills, and a
JSON object as the last line (also written to
``build/probe/flash_probe.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import TF32_PASSES, attention_bound, time_ms  # noqa: E402
from scripts.sketch_sim_probe import PROBE_BUILD, compile_all, smi  # noqa: E402

BH, S = 8, 4096
CASES = [(256, -1), (256, 512), (128, -1), (128, 512), (64, -1), (64, 512)]
TOL = 2e-5


def other_flash(torch, lib):
    """fn(q, k, v, window) through another revision's C entry point."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with_lse = hasattr(lib, "flash_attention_lse_launch")
    entry = (lib.flash_attention_lse_launch if with_lse
             else lib.flash_attention_launch)
    entry.restype = i
    entry.argtypes = [p, p, p, p, *([p] if with_lse else []), i, i, i, i, i,
                      i, f, p]

    def run(q, k, v, window):
        bh, sq, hd = q.shape
        out = torch.empty_like(q)
        lse = [None] if with_lse else []
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   *lse, bh, sq, k.shape[1], hd, k.shape[1], window,
                   1.0 / math.sqrt(hd),
                   torch.cuda.current_stream(q.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{entry.__name__} error {rc}")
        return out

    return run


def sdpa(torch, q, k, v, window):
    import torch.nn.functional as F

    if window < 0:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    pos = torch.arange(q.shape[1], device=q.device)
    band = ((pos[None, :] <= pos[:, None])
            & (pos[:, None] - pos[None, :] < window))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/flash_attention.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--hd", type=int, action="append", default=[],
                    help="time only these head dims (default: 256, 128, 64)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as kern

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    libs = compile_all(list(args.other))
    kern.library()
    for r in _build.ptxas_report("flash_attention"):
        print(f"this tree: {r['kernel']}: {r['registers']} registers, spill "
              f"stores {r['spill_stores']} B, loads {r['spill_loads']} B",
              flush=True)
    fns = {"this tree": lambda q, k, v, w: ops.flash_attention(q, k, v,
                                                               window=w)}
    for src in args.other:
        fns[str(src)] = other_flash(torch, libs[src])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    result = {"card": card, "bh": BH, "s": S, "cases": [], "accuracy": []}
    for hd in (64, 256):
        q, k, v = (torch.randn((2, 1024, hd), generator=gen, device=dev)
                   for _ in range(3))
        for scale in (1, 6):
            qs, ks = q * scale, k * scale
            truth = ref.flash_attention(qs.double(), ks.double(), v.double(),
                                        -1)
            errs = {name: float((fn(qs, ks, v, -1).double() - truth)
                                .abs().max()) for name, fn in fns.items()}
            errs["plain (float32)"] = float((ref.flash_attention(
                qs, ks, v, -1).double() - truth).abs().max())
            result["accuracy"].append({"hd": hd, "qk_scale": scale,
                                       "max_abs_err_vs_float64": errs})
            print(f"accuracy hd {hd} q, k x{scale}: max abs err against "
                  "float64: " + ", ".join(f"{n} {e:.3g}"
                                          for n, e in errs.items()),
                  flush=True)
        del q, k, v, qs, ks, truth
    for hd, window in CASES:
        if args.hd and hd not in args.hd:
            continue
        q, k, v = (torch.randn((BH, S, hd), generator=gen, device=dev)
                   for _ in range(3))
        want = ref.flash_attention(q, k, v, window)
        for name, fn in fns.items():
            got = fn(q, k, v, window)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=TOL, atol=TOL):
                err = float((got.double() - want.double()).abs().max())
                raise SystemExit(f"{name} hd {hd} window {window}: max abs "
                                 f"err {err} above {TOL}")
        del want, got
        tc, _ = attention_bound(BH, S, hd, window, TF32_PASSES)
        fp32, _ = attention_bound(BH, S, hd, window)
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(time_ms(
                    torch, lambda f=fns[name]: f(q, k, v, window)))
        times["sdpa (float32)"] = [time_ms(torch, sdpa(torch, q, k, v,
                                                       window))]
        case = {"hd": hd, "window": window, "tc_bound_ms": tc[0],
                "fp32_bound_ms": fp32[0], "ms": {}}
        for name, ts in times.items():
            ms = statistics.median(ts)
            case["ms"][name] = {"median": ms, "rounds": ts}
            print(f"hd {hd} window {window} {name}: {ms:.4f} ms (rounds "
                  f"{', '.join(f'{t:.4f}' for t in ts)}); tensor-core bound "
                  f"{tc[0]:.4f} ms ({tc[0] / ms:.1%}), fp32 bound "
                  f"{fp32[0]:.4f} ms ({fp32[0] / ms:.1%})", flush=True)
        result["cases"].append(case)
        del q, k, v
    result["clocks_sm_now_max"] = smi("clocks.sm,clocks.max.sm")
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    (PROBE_BUILD / "flash_probe.json").write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
