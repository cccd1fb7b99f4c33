"""Serving launcher: batched greedy generation on a reduced config (the
port's counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --batch 4

``--arch`` is any of the ten archs of ``configs.registry``.  Runs on the
card unless ``--device cpu``; without a GPU it raises.
Parameters and prompts are drawn from seeds 0 and 1 with torch's
generator, so the tokens are not ``repro``'s (its keys are JAX's).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.lm import ServeLoop

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    loop = ServeLoop(cfg, params, max_len=args.prompt_len + args.new_tokens)

    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    t0 = time.time()
    out = loop.generate(prompts, n_new=args.new_tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"{cfg.name}: generated {args.batch}x{args.new_tokens} tokens "
          f"in {dt:.2f}s ({args.batch*args.new_tokens/dt:.1f} tok/s)")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
