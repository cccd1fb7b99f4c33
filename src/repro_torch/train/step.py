"""The train step (counterpart of ``repro.train.step``): the loss and its
gradients, accumulated over microbatches, then AdamW.

Microbatching trades activation memory for step time: the batch's rows
split into ``microbatches`` equal slices, each slice's float32 gradients
add into one tree, and the loss and the gradients are divided by the
count at the end, as ``repro``'s ``lax.scan`` of slices does.  Remat is
``forward``'s, per layer (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (lm_loss, tree_from_leaves,
                                            tree_leaves, tree_map)
from repro_torch.train.optimizer import AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    loss_chunk: int = 512
    optimizer: AdamWConfig = AdamWConfig()
    # the matmuls' dtype (``models/layers.py``): None is bfloat16 on the
    # card, float32 on the CPU
    compute_dtype: torch.dtype | None = None


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns grad_fn(params, tokens, labels[, frontend_embeds]) -> (loss,
    grads): the mean loss (float32, 0-dim) and its gradient, a tree shaped
    as ``params`` (float32; zeros for a parameter the loss does not
    reach), over ``tcfg.microbatches`` slices of the batch's rows."""

    def one(params, tokens, labels, fe):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = lm_loss(live, tokens, labels, cfg,
                           loss_chunk=tcfg.loss_chunk, frontend_embeds=fe,
                           compute_dtype=tcfg.compute_dtype)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() for p, g in zip(leaves, grads)]
        return loss.detach(), tree_from_leaves(params, grads)

    def grad_fn(params, tokens, labels, frontend_embeds=None):
        mb = tcfg.microbatches
        b = tokens.shape[0]
        if b % mb:
            raise ValueError(f"batch {b} does not split into {mb} "
                             f"microbatches")
        if mb == 1:
            return one(params, tokens, labels, frontend_embeds)
        rows = b // mb
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(mb):
            part = slice(i * rows, (i + 1) * rows)
            fe = None if frontend_embeds is None else frontend_embeds[part]
            l_i, g_i = one(params, tokens[part], labels[part], fe)
            loss = loss + l_i
            for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                acc.add_(g)
            del g_i
        for acc in tree_leaves(grads):
            acc.div_(mb)
        return loss / mb, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns train_step(params, opt_state, tokens, labels[,
    frontend_embeds]) -> (params, opt_state, metrics {"loss",
    "grad_norm", "lr"}); tokens and labels (B, S) integer.  The parameters
    and moments are updated in place (:func:`adamw_update`)."""
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(params, opt_state, tokens, labels, frontend_embeds=None):
        loss, grads = grad_fn(params, tokens, labels, frontend_embeds)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, tcfg.optimizer)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step
