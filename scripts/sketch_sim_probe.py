#!/usr/bin/env python3
"""What the sketch_sim kernel can reach on the card, and how it compares
with another revision of it, under one timer.

    python3 scripts/sketch_sim_probe.py [--other PATH/sketch.cu ...]

Needs one CUDA GPU (built for sm_90a).  At the sketch gate's shape in
``chip_smoke.py`` (B 4096, S 64, K 10,000), on dense operands from a
fixed seed (no zero in the doc sketches, so no zero skip applies; the
gate's doc sketches are 98% live), it times

- this checkout's ``ops.sketch_sim`` and every ``--other`` source (a
  ``csrc/sketch.cu`` of another revision with the same C interface, e.g.
  unpacked with ``git archive``), each held bit for bit against the plain
  version ``ref.sketch_sim`` on the card;
- ``torch.matmul`` (no TF32), the library yardstick;

each with ``chip_smoke.time_ms`` (calls back to back, about 2 ms per rep)
and with one call per rep (the host's launch cost included), and

- the FP32 pipe's issue rate for FMUL+FADD pairs and for FFMA, from
  register-only loops (``scripts/fp32_rate.cu``), and from it the
  reachable no-FMA floor 2·B·S·K / rate.

Prints the card's name and power limit, one line per measurement, and a
JSON object as the last line (also written to
``build/probe/sketch_sim_probe.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import time_ms  # noqa: E402

PROBE_BUILD = ROOT / "build" / "probe"
RATE_SOURCE = ROOT / "scripts" / "fp32_rate.cu"
B, S, K = 4096, 64, 10_000


def compile_all(sources: list[Path]) -> dict[Path, ctypes.CDLL]:
    """One nvcc per source, all together, with the port's flags."""
    from repro_torch.kernels import _build

    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sources:
        tag = hashlib.sha256(_build.source_bytes(src)
                             + " ".join(_build.NVCC_FLAGS).encode())
        out = PROBE_BUILD / f"{src.stem}-{tag.hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
        jobs[src] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for src, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {src}: " + " | ".join(regs), flush=True)
        libs[src] = ctypes.CDLL(str(out))
    return libs


def one_call_ms(torch, fn, reps: int = 5) -> float:
    """Median of ``reps`` single calls from CUDA events, after a warm-up."""
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


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another revision's csrc/sketch.cu to time too")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sketch_sim_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit").splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = compile_all([RATE_SOURCE, *args.other])

    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, k = B, S, K
    x = torch.rand((b, s), generator=gen, device=dev) + 0.01
    m = torch.rand((s, k), generator=gen, device=dev)
    want = ref.sketch_sim(x, m)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ops_n = 2 * b * s * k
    result = {"card": card, "shape": [b, s, k]}

    def measure(name, fn, exact=True):
        got = fn()
        torch.cuda.synchronize()
        if exact and not torch.equal(got, want):
            raise SystemExit(f"{name}: differs from the plain version")
        row = {"ms": time_ms(torch, fn), "one_call_ms": one_call_ms(torch, fn)}
        print(f"{name}: {row['ms']:.4f} ms back to back, "
              f"{row['one_call_ms']:.4f} ms one call per rep"
              + (", bitwise equal to plain" if exact else ""), flush=True)
        return row

    result["sketch_sim"] = measure("sketch_sim (this tree)",
                                   lambda: ops.sketch_sim(x, m))
    for src in args.other:
        lib = libs[src]
        f = lib.sketch_sim_launch
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p]

        def other(f=f):
            out = torch.empty((b, k), dtype=torch.float32, device=dev)
            rc = f(x.data_ptr(), m.data_ptr(), b, s, k, out.data_ptr(),
                   stream)
            if rc:
                raise RuntimeError(f"{src}: launch error {rc}")
            return out

        result[str(src)] = measure(f"sketch_sim ({src})", other)
    result["torch.matmul"] = measure("torch.matmul (no TF32)",
                                     lambda: torch.matmul(x, m), exact=False)

    rate = libs[RATE_SOURCE]
    rate.fp32_rate_launch.restype = ctypes.c_int
    rate.fp32_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    chains = rate.fp32_rate_chains()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, iters = sms * 8, 2048
    sink = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    for mode, name, per_step in ((0, "fmul_fadd", 2), (1, "ffma", 1)):
        def loop(mode=mode):
            rc = rate.fp32_rate_launch(sink.data_ptr(), blocks, iters, mode,
                                       stream)
            if rc:
                raise RuntimeError(f"fp32_rate mode {mode}: error {rc}")
        ms = time_ms(torch, loop)
        instr = blocks * 256 * iters * chains * per_step
        per_s = instr / (ms * 1e-3)
        result[name] = {"ms": ms, "instructions": instr,
                        "instructions_per_s": per_s}
        print(f"{name} loop: {instr} FP32 instructions in {ms:.4f} ms = "
              f"{per_s:.4e} per s", flush=True)
    clocks = smi("clocks.sm,clocks.max.sm").splitlines()[0]
    lanes = sms * 128
    print(f"SM clock now, max: {clocks}; {sms} SMs x 128 FP32 lanes",
          flush=True)
    fmul_fadd = result["fmul_fadd"]["instructions_per_s"]
    result["sms"] = sms
    result["clocks_sm_now_max"] = clocks
    result["fmul_fadd_per_lane_GHz"] = fmul_fadd / lanes / 1e9
    result["reachable_no_fma_floor_ms"] = ops_n / fmul_fadd * 1e3
    print(f"FMUL+FADD per lane: {result['fmul_fadd_per_lane_GHz']:.4f} "
          f"GHz; reachable no-FMA floor at B {b} S {s} K {k}: "
          f"{result['reachable_no_fma_floor_ms']:.4f} ms", flush=True)

    (PROBE_BUILD / "sketch_sim_probe.json").write_text(json.dumps(result,
                                                                  indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
