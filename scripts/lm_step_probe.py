#!/usr/bin/env python3
"""The LM serving prefill against another revision's, under one timer,
and where a training step's time goes.

    python3 scripts/lm_step_probe.py [--other ROOT ...] [--rounds R]
                                     [--train-steps N] [--seed S]

ROOT is another checkout of the repo, e.g. the parent's unpacked into the
ignored build directory:

    mkdir -p build/probe/parent
    git archive HEAD~1 | tar -x -C build/probe/parent

Needs one CUDA GPU (the kernels are built for sm_90a).

Prefill: gemma3-1b (26 layers) and xlstm-125m (12) at full width, weights
from ``--seed``, B 2 × S 4096, bf16 compute, through each checkout's
``serve.lm.make_prefill_fn``, called under grad mode as ``chip_smoke.py``'s
LM phases call it.  Each checkout runs in a process of its own (both are
``repro_torch``), and so does "remat": this checkout's ``forward`` with
``remat=True`` under grad mode, every layer under
``torch.utils.checkpoint``.  The runs go in ``--rounds`` rounds whose order
alternates (others, this, remat, then remat, this, others).  Each run gives
the first call, the median and least of 5 warm calls (host clock, the
device synchronised), the peak, and one call under ``torch.profiler``: the
device kernels' summed time and the idle share of the wall time.

Training (this checkout only): the same two archs through
``train.make_train_step`` as ``launch/train.py`` runs them (parameters
seeded 0, tokens from ``numpy.random.default_rng(0)``, bf16), N steps each
timed on the host clock with the metrics read back (the token draw
included, which the launcher leaves out), the peak, then one more step
under the profiler, its kernels grouped as ``chip_smoke.device_groups``
groups them (the backward kernels by name).

Prints the card's name and power limit first and a JSON object as the
last line (also written to ``build/probe/lm_step_probe.json``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma3-1b", "xlstm-125m")
BATCH, SEQ = 2, 4096
WARM = 5


def _sync_s(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def _busy_ms(torch, fn) -> tuple[float, float, int]:
    """(wall ms, device kernels' summed ms, kernels) of one call of ``fn``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _sync_s(torch, fn)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return wall * 1e3, busy, len(kernels)


def child(root: Path, variant: str, seed: int) -> int:
    """One checkout's prefills, as a JSON line on stdout."""
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch
    from repro_torch.configs import registry
    from repro_torch.models.transformer import forward, init_params, logits
    from repro_torch.serve.lm import make_prefill_fn

    src = Path(repro_torch.__file__).resolve()
    if root.resolve() not in src.parents:
        raise RuntimeError(f"imported {src}, not the checkout at {root}")
    out = {}
    for arch in ARCHS:
        cfg = registry.get_config(arch)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, device=dev)
        tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen,
                               device=dev, dtype=torch.int32)
        if variant == "remat":
            def prefill(p, t, _cfg=cfg):
                h = forward(p, t, _cfg, remat=True)
                return logits(p, h[:, -1:, :], _cfg)[:, 0, :_cfg.vocab]
        else:
            prefill = make_prefill_fn(cfg)
        assert torch.is_grad_enabled()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first, lg = _sync_s(torch, lambda: prefill(params, tokens))
        if not bool(torch.isfinite(lg).all()):
            raise RuntimeError(f"{arch}: non-finite prefill logits")
        times = [_sync_s(torch, lambda: prefill(params, tokens))[0]
                 for _ in range(WARM)]
        wall, busy, n = _busy_ms(torch, lambda: prefill(params, tokens))
        out[arch] = dict(first_ms=first * 1e3,
                         median_ms=statistics.median(times) * 1e3,
                         min_ms=min(times) * 1e3,
                         ms=[t * 1e3 for t in times],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         profiled_wall_ms=wall, device_busy_ms=busy,
                         idle=1 - busy / wall, kernels=n)
        del params, lg
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def run_child(root: Path, variant: str, seed: int) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(root), "--variant", variant, "--seed", str(seed)],
        capture_output=True, text=True, cwd=str(root))
    if proc.returncode:
        raise RuntimeError(f"{variant} run in {root} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def train_rows(torch, steps: int) -> dict:
    """This checkout's training steps, timed and then profiled."""
    import numpy as np

    from chip_smoke import device_groups
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.train import TrainConfig, adamw_init, make_train_step

    out = {}
    for arch in ARCHS:
        cfg = registry.get_config(arch)
        dev = torch.device("cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        opt = adamw_init(params)
        step_fn = make_train_step(cfg, TrainConfig())
        rng = np.random.default_rng(0)

        def step():
            nonlocal params, opt
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)).to(dev)
            labels = torch.roll(toks, -1, dims=1)
            params, opt, m = step_fn(params, opt, toks, labels)
            return [float(m[k]) for k in ("loss", "grad_norm", "lr")]

        ops.reset_counts()
        secs, metrics = [], []
        for _ in range(steps):
            t = time.perf_counter()
            metrics.append(step())
            secs.append(time.perf_counter() - t)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        wall, groups, n, top = device_groups(torch, step)
        busy = sum(groups.values())
        out[arch] = dict(
            step_s=secs, median_after_first_s=statistics.median(secs[1:]),
            losses=[m[0] for m in metrics], launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            profiled_wall_ms=wall * 1e3, device_busy_ms=busy,
            idle=1 - busy / (wall * 1e3), kernels=n, groups=groups,
            top=[[name[:100], ms] for name, ms in top])
        print(f"train {arch}: steps {[round(s, 4) for s in secs]} s; peak "
              f"{out[arch]['peak_gib']:.2f} GiB; launches {launches}; "
              f"profiled step: wall {wall * 1e3:.1f} ms, {n} kernels, busy "
              f"{busy:.1f} ms (idle {out[arch]['idle']:.1%}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in groups.items()),
              flush=True)
        for name, ms in top:
            print(f"    {ms:8.2f} ms  {name[:100]}", flush=True)
        del params, opt, step_fn
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--train-steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--variant", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.variant, args.seed)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("lm_step_probe: no CUDA device", file=sys.stderr)
        return 1
    from scripts.sketch_sim_probe import PROBE_BUILD, smi

    print(smi("name,power.limit").splitlines()[0], flush=True)
    runs = [(str(o), o.resolve(), "this") for o in args.other]
    runs += [("this", ROOT, "this"), ("remat", ROOT, "remat")]
    prefill: dict = {name: [] for name, _, _ in runs}
    for r in range(args.rounds):
        for name, root, variant in (runs if r % 2 == 0 else runs[::-1]):
            rec = run_child(root, variant, args.seed)
            prefill[name].append(rec)
            print(f"round {r} {name}: " + "; ".join(
                f"{a} median {v['median_ms']:.1f} ms (least {v['min_ms']:.1f},"
                f" first {v['first_ms']:.1f}), profiled {v['profiled_wall_ms']:.1f}"
                f" ms, busy {v['device_busy_ms']:.1f} (idle {v['idle']:.1%}), "
                f"peak {v['peak_gib']:.2f} GiB" for a, v in rec.items()),
                flush=True)
    train = train_rows(torch, args.train_steps)
    result = {"card": smi("name,power.limit").splitlines()[0],
              "batch": BATCH, "seq": SEQ, "prefill": prefill,
              "train": train}
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    (PROBE_BUILD / "lm_step_probe.json").write_text(json.dumps(result))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
