"""LM serving: the prefill and decode step factories and the greedy loop.
The port's counterpart of ``repro.serve.lm``, in eager PyTorch (no jit;
CUDA graphs are later work).

  prefill_fn(params, tokens (B, S)[, frontend_embeds (B, S_fe, D)])
                                                 -> next-token logits (B, V)
  decode_fn(params, cache, token (B, 1), pos)    -> (logits (B, 1, V), cache)

The prefill runs every attention layer through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`) and every sLSTM layer
through the sLSTM scan (:func:`repro_torch.kernels.ops.slstm_scan`); with
mamba2 or mLSTM layers its S must be a multiple of ``cfg.ssm_chunk``.  The
decode path updates each layer's cache dict in place: the KV caches, and
the SSM states (an sLSTM step is one ``slstm_scan`` launch of S = 1).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_forward, forward,
                                            init_cache, logits)


def make_prefill_fn(cfg: ModelConfig, *, compute_dtype=None):
    def prefill(params, tokens, frontend_embeds=None):
        h = forward(params, tokens, cfg, frontend_embeds=frontend_embeds,
                    compute_dtype=compute_dtype, remat=False)
        out = logits(params, h[:, -1:, :], cfg, compute_dtype=compute_dtype)
        return out[:, 0, :cfg.vocab]
    return prefill


def make_decode_fn(cfg: ModelConfig, *, compute_dtype=None):
    def decode(params, cache, token, pos):
        return decode_forward(params, cache, token, pos, cfg,
                              compute_dtype=compute_dtype)
    return decode


class ServeLoop:
    """Minimal batched serving loop (greedy).  The caches live on the
    parameters' device."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256, *,
                 compute_dtype=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self._decode = make_decode_fn(cfg, compute_dtype=compute_dtype)

    @torch.no_grad()
    def generate(self, prompts: torch.Tensor, n_new: int = 16) -> torch.Tensor:
        """prompts: (B, S0) integer -> (B, S0 + n_new) int32 greedy
        continuation.  The prompt is teacher-forced through the decode path
        to warm the caches (exact, if slow), as ``repro`` does."""
        b, s0 = prompts.shape
        dev = self.params["embed"].device
        prompts = prompts.to(device=dev, dtype=torch.int32)
        cache = init_cache(self.cfg, b, self.max_len, device=dev,
                           compute_dtype=self.compute_dtype)
        tok = prompts[:, :1]
        out = [prompts]
        for pos in range(s0 + n_new - 1):
            lg, cache = self._decode(self.params, cache, tok, pos)
            nxt = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            tok = prompts[:, pos + 1:pos + 2] if pos + 1 < s0 else nxt
            if pos + 1 >= s0:
                out.append(nxt)
        return torch.cat(out, dim=1)
