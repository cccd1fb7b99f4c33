"""Transformer building blocks of the dense-attention family: RMSNorm, RoPE,
GQA attention (sliding window) for prefill and for one decode step, and the
dense MLP variants.  The port's counterpart of ``repro.models.layers``.

Compute-dtype rule (``repro/models/layers.py:21-29``, made explicit): the
parameters are float32; matmuls run in the compute dtype ``cd``, bfloat16
on the card and float32 on the CPU by default (:func:`compute_dtype`), and
every function takes ``cd`` as an argument, so that a cross-check can run
float32 on both.  Where ``repro`` asks for float32 accumulation of a bf16
product (``preferred_element_type``), the port upcasts the bf16 operands
and multiplies in float32 (products of bf16 values are exact in float32).

Prefill attention always goes through :func:`repro_torch.kernels.ops.
flash_attention` (the CUDA kernel for CUDA tensors, its plain version for
CPU tensors), with q/k/v cast to float32 and the GQA heads folded into the
batch as ``repro``'s ``_flash_path`` does.  ``moe_mlp``, the int8 KV cache
and ``repro``'s sharding switches are not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def compute_dtype(device, override=None) -> torch.dtype:
    """bfloat16 on the card, float32 on the CPU, unless ``override``."""
    if override is not None:
        return override
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def rms_norm(x, scale, eps: float):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale)).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def band_mask(q_pos, k_pos, window: int):
    """Causal band: k <= q and q - k < window (window < 0: full causal)."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window < 0:
        return causal
    return causal & ((q_pos[:, None] - k_pos[None, :]) < window)


def _qkv(xc, p, cfg: ModelConfig, cd):
    q = xc @ p["wq"].to(cd)
    k = xc @ p["wk"].to(cd)
    v = xc @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def attention(x, p, cfg: ModelConfig, window: int, cd):
    """Prefill attention from position 0. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    q, k, v = _qkv(x.to(cd), p, cfg, cd)
    positions = torch.arange(s, device=x.device)[None, :]
    q = rope(q.reshape(b, s, hq, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, hd)
    # GQA fold: head h = kv head h // g; k/v repeated g times into BH.
    qf = q.permute(0, 2, 1, 3).reshape(b * hq, s, hd)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).reshape(b * hq, s, hd)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).reshape(b * hq, s, hd)
    out = ops.flash_attention(qf.float().contiguous(), kf.float().contiguous(),
                              vf.float().contiguous(), window=int(window))
    out = out.reshape(b, hq, s, hd).permute(0, 2, 1, 3).reshape(b, s, hq * hd)
    return (out.to(cd) @ p["wo"].to(cd)).to(x.dtype)


def decode_attention(x, p, cfg: ModelConfig, window: int, cache_k, cache_v,
                     pos: int, cd):
    """One decode step. x: (B, 1, D); caches (B, L_c, Hkv, hd), where L_c =
    min(window, S_max) for windowed layers (rotating) or S_max; pos: the
    token's absolute position.  Writes the new key and value into slot
    pos mod L_c of the caches in place and returns (out, cache_k, cache_v).

    Slot j holds absolute position pos - ((slot - j) mod L_c); keys are
    stored RoPE'd at their absolute position."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    l_c = cache_k.shape[1]
    slot = pos % l_c
    q, k, v = _qkv(x.to(cd), p, cfg, cd)
    posv = torch.full((1, 1), pos, device=x.device)
    q = rope(q.reshape(b, 1, hq, hd), posv, cfg.rope_theta)
    k = rope(k.reshape(b, 1, hkv, hd), posv, cfg.rope_theta)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v.reshape(b, hkv, hd).to(cache_v.dtype)

    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          cache_k.to(cd).float()) / math.sqrt(float(hd))
    j = torch.arange(l_c, device=x.device)
    k_pos = pos - torch.remainder(slot - j, l_c)         # absolute positions
    mask = band_mask(posv[0], k_pos, window)[0] & (k_pos >= 0)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.float(),
                       cache_v.to(cd).float())
    out = out.reshape(b, 1, hq * hd).to(cd)
    return (out @ p["wo"].to(cd)).to(x.dtype), cache_k, cache_v


def dense_mlp(x, p, cfg: ModelConfig, cd):
    xc = x.to(cd)
    if cfg.mlp in ("swiglu", "geglu"):
        gate = xc @ p["w_gate"].to(cd)
        act = F.silu(gate) if cfg.mlp == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * (xc @ p["w_up"].to(cd))
    else:
        h = F.gelu(xc @ p["w_up"].to(cd), approximate="tanh")
    return (h @ p["w_down"].to(cd)).to(x.dtype)
