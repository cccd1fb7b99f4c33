"""Training launcher on one card (the port's counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 30 --checkpoint-dir CKPT_DIR [--device cpu]

Runs on the card unless ``--device cpu``; without a GPU the default
raises.  Parameters come from ``init_params`` with a torch generator
seeded 0, tokens from ``numpy.random.default_rng(0)`` (one (batch, seq)
draw a step), labels the tokens rolled by one.  Fault tolerance: it
resumes from the newest checkpoint under ``--checkpoint-dir`` (the
generator skips the draws of the steps already taken, so a resumed run
equals an uninterrupted one bit for bit), saves every
``--checkpoint-every`` steps through an ``AsyncCheckpointer`` in
``repro``'s stacked layout ({"opt": AdamW state, "params"}), and the
``StepWatchdog`` flags straggling steps.  ``repro``'s ``--mesh`` and
multi-host start are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _state(params, opt, cfg) -> dict:
    from repro_torch.convert import adamw_state_to_numpy, lm_params_to_numpy

    return {"opt": adamw_state_to_numpy(opt, cfg),
            "params": lm_params_to_numpy(params, cfg)}


def main(argv=None) -> dict:
    """Runs the steps; returns {"cfg", "params", "opt", "history"}, one
    history entry a step taken here: step, loss, grad_norm, lr, seconds
    (host clock, the step's results read back) and straggler."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore_checkpoint)
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.convert import (adamw_state_from_numpy,
                                     lm_params_from_numpy)
    from repro_torch.distributed.elastic import StepWatchdog
    from repro_torch.models.transformer import init_params
    from repro_torch.train import TrainConfig, adamw_init, make_train_step

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"device {dev}, arch {cfg.name} ({cfg.n_params():,} params)")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = adamw_init(params)

    start = 0
    if args.checkpoint_dir and latest_step(args.checkpoint_dir) is not None:
        tree, start = restore_checkpoint(args.checkpoint_dir,
                                         _state(params, opt, cfg))
        params = lm_params_from_numpy(tree["params"], cfg, device=dev)
        opt = adamw_state_from_numpy(tree["opt"], cfg, device=dev)
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, TrainConfig(microbatches=args.microbatches))
    ck = AsyncCheckpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    wd = StepWatchdog()
    rng = np.random.default_rng(0)
    shape = (args.batch, args.seq)
    for _ in range(start):
        rng.integers(0, cfg.vocab, shape)
    history = []
    for i in range(start, args.steps):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, shape).astype(np.int32)).to(dev)
        labels = torch.roll(toks, -1, dims=1)
        wd.start()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, toks, labels)
        loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        seconds = time.perf_counter() - t0
        straggle = wd.stop()
        history.append(dict(step=i, loss=loss, grad_norm=gnorm, lr=lr,
                            seconds=seconds, straggler=straggle))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
                  f"{seconds:.3f} s"
                  + ("  [straggler-budget breach]" if straggle else ""))
        if ck and (i + 1) % args.checkpoint_every == 0:
            ck.save(_state(params, opt, cfg), step=i + 1)
    if ck:
        ck.wait()
    print("done")
    return {"cfg": cfg, "params": params, "opt": opt, "history": history}


if __name__ == "__main__":
    main()
