"""AdamW with global-norm clipping and linear warm-up, as plain functions
on tensor trees (``repro.train.optimizer``'s update, not
``torch.optim.AdamW``, whose step differs: it decays the parameters
before the Adam step and has no clipping or warm-up of its own).

A tree is the port's parameter layout (``models/transformer.py``): dicts,
lists and tensors, where one dict may appear at several places (zamba2's
``shared`` block); ``tree_map`` maps such a dict once and ``tree_leaves``
lists each tensor once.

The update works in place on the parameters and the moments (no second
copy of a 16 GB state at gemma3-1b's width) and returns them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> dict:
    """Zero moments shaped as the parameters, and a step count of 0
    (int32, on the parameters' device)."""
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, count):
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree):
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """One AdamW step in ``repro``'s order: the clip scale min(1, clip /
    max(|g|, 1e-12)), lr · min(count / warmup, 1), the bias corrections,
    and the decay added to the step before the lr:

        g = g·scale;  mu = b1·mu + (1 - b1)·g;  nu = b2·nu + (1 - b2)·g·g
        p = p - lr·((mu / b1c) / (sqrt(nu / b2c) + eps) + wd·p)

    Updates ``params`` and the moments in place.  Returns (params,
    opt_state, {"grad_norm", "lr"})."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = _schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        den = torch.sqrt(nu / b2c).add_(cfg.eps)
        step = torch.div(mu, b1c).div_(den)
        del den
        pf = p.float()
        step.add_(cfg.weight_decay * pf)
        p.copy_((pf - lr * step).to(p.dtype))
    opt_state = {"mu": opt_state["mu"], "nu": opt_state["nu"],
                 "count": count}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
