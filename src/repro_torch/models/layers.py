"""Transformer building blocks of the attention family: RMSNorm, RoPE,
GQA attention (sliding window) for prefill and for one decode step (KV
cache in the compute dtype or int8), the dense MLP variants and the
capacity-based top-k MoE MLP.  The port's counterpart of
``repro.models.layers``.

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
batch as ``repro``'s ``_flash_path`` does.  ``repro``'s sharding switches
are not ported.
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


def _cache_insert(cache, new, slot: int) -> None:
    """Writes one token's keys or values (B, 1, Hkv, hd) into ``slot`` of a
    cache in place.  An int8 cache ({"q": int8 codes, "s": float32}) takes
    ``repro``'s per-(token, kv-head) max-abs codes: round(x / max(scale,
    1e-9) * 127), half to even, and stores scale / 127."""
    if not isinstance(cache, dict):
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    scale = new.abs().amax(dim=-1, keepdim=True).float()
    codes = torch.round(new.float() / torch.clamp(scale, min=1e-9) * 127.0)
    cache["q"][:, slot] = codes[:, 0].to(torch.int8)
    cache["s"][:, slot] = scale[:, 0] / 127.0


def _cache_read(cache, cd):
    if not isinstance(cache, dict):
        return cache.to(cd)
    return (cache["q"].float() * cache["s"]).to(cd)


def decode_attention(x, p, cfg: ModelConfig, window: int, cache_k, cache_v,
                     pos: int, cd):
    """One decode step. x: (B, 1, D); caches (B, L_c, Hkv, hd), where L_c =
    min(window, S_max) for windowed layers (rotating) or S_max, either in
    the compute dtype or int8 ({"q": (B, L_c, Hkv, hd) int8, "s": (B, L_c,
    Hkv, 1) float32}); pos: the token's absolute position.  Writes the new
    key and value into slot pos mod L_c of the caches in place and returns
    (out, cache_k, cache_v).

    Slot j holds absolute position pos - ((slot - j) mod L_c); keys are
    stored RoPE'd at their absolute position."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    l_c = (cache_k["q"] if isinstance(cache_k, dict) else cache_k).shape[1]
    slot = pos % l_c
    q, k, v = _qkv(x.to(cd), p, cfg, cd)
    posv = torch.full((1, 1), pos, device=x.device)
    q = rope(q.reshape(b, 1, hq, hd), posv, cfg.rope_theta)
    k = rope(k.reshape(b, 1, hkv, hd), posv, cfg.rope_theta)
    _cache_insert(cache_k, k, slot)
    _cache_insert(cache_v, v.reshape(b, 1, hkv, hd), slot)

    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          _cache_read(cache_k, cd).float()) / math.sqrt(float(hd))
    j = torch.arange(l_c, device=x.device)
    k_pos = pos - torch.remainder(slot - j, l_c)         # absolute positions
    mask = band_mask(posv[0], k_pos, window)[0] & (k_pos >= 0)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.float(),
                       _cache_read(cache_v, cd).float())
    out = out.reshape(b, 1, hq * hd).to(cd)
    return (out @ p["wo"].to(cd)).to(x.dtype), cache_k, cache_v


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def dense_mlp(x, p, cfg: ModelConfig, cd):
    xc = x.to(cd)
    if cfg.mlp in ("swiglu", "geglu"):
        gate = xc @ p["w_gate"].to(cd)
        act = F.silu(gate) if cfg.mlp == "swiglu" else _gelu(gate)
        h = act * (xc @ p["w_up"].to(cd))
    else:
        h = _gelu(xc @ p["w_up"].to(cd))
    return (h @ p["w_down"].to(cd)).to(x.dtype)


def moe_capacity(cfg: ModelConfig, g: int) -> int:
    """Slots an expert has in a routing group of g tokens: ``repro``'s
    float arithmetic, rounded up to a multiple of 4, at most g."""
    cap = int(g * cfg.top_k / cfg.n_experts * cfg.moe_capacity) + 1
    return min(cap + (-cap) % 4, g)


def top_k_lower_first(x, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    the lower index first among equal values (``jax.lax.top_k``'s rule,
    which ``torch.topk`` does not keep)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(x, p, cfg: ModelConfig, cd):
    """Capacity-based top-k MoE: ``repro``'s GShard/Switch routing with the
    one-hot dispatch and combine einsums done as index gathers.

    The B·S tokens split into groups of g = min(moe_group, B·S) (an
    indivisible count raises).  Each token picks its top_k experts by
    router logit (lower expert id first on ties) and gates them by a
    softmax over the k logits; within a group a token takes slot
    (earlier tokens of the group that picked the expert) of that expert,
    and is dropped there at a slot >= capacity.  Router logits, gates, the
    expert outputs and the combine are float32; the three expert products
    run on the compute-dtype operands in float32 (the module's rule), the
    gate and up products are rounded to the compute dtype before the
    activation, as in ``repro``."""
    xin, dest, w = _moe_dispatch(x, p, cfg, cd)
    out_e = _moe_experts(xin, p, cfg, cd)
    return _moe_combine(out_e, dest, w).reshape(x.shape).to(x.dtype)


def _moe_dispatch(x, p, cfg: ModelConfig, cd):
    """Routing and dispatch: (xin (E, groups·capacity, D) float32, each
    pick's slot index into it (dropped picks: E·groups·capacity), each
    pick's gate (0 where dropped) (B·S, k, 1))."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = min(cfg.moe_group, t)
    if t % g:
        raise ValueError(f"{t} tokens do not split into routing groups of "
                         f"{g} (moe_group {cfg.moe_group})")
    ng = t // g
    cap = moe_capacity(cfg, g)
    dev = x.device
    xf = x.reshape(ng, g, d).to(cd)
    logits = (xf @ p["router"].to(cd)).float()                 # (ng, g, e)
    gate_vals, gate_idx = top_k_lower_first(logits, k)         # (ng, g, k)
    gates = torch.softmax(gate_vals, dim=-1)
    picked = torch.zeros((ng, g, e), dtype=torch.int64, device=dev)
    picked.scatter_(-1, gate_idx, 1)
    arrival = torch.cumsum(picked, dim=1) - picked             # slot in expert
    slot = arrival.gather(-1, gate_idx)                        # (ng, g, k)
    keep = slot < cap
    # Slots laid out (expert, group, capacity); a dropped pick writes to
    # the extra slot n_slots, which is never read.
    n_slots = e * ng * cap
    group = torch.arange(ng, device=dev).view(ng, 1, 1)
    dest = torch.where(keep, (gate_idx * ng + group) * cap + slot, n_slots)
    token = torch.arange(t, device=dev).view(ng, g, 1).expand(ng, g, k)
    filled_by = torch.full((n_slots + 1,), t, dtype=torch.int64, device=dev)
    filled_by.index_copy_(0, dest.reshape(-1), token.reshape(-1))
    x_pad = torch.cat([xf.reshape(t, d), xf.new_zeros((1, d))])   # row t: 0
    xin = x_pad[filled_by[:n_slots]].view(e, ng * cap, d).float()
    w = torch.where(keep, gates, 0.0).reshape(t, k, 1)
    return xin, dest.reshape(t, k), w


def _moe_experts(xin, p, cfg: ModelConfig, cd):
    """The experts' SwiGLU/GeGLU on their slots -> (E, slots, D) float32."""
    act = F.silu if cfg.mlp == "swiglu" else _gelu
    h = act(torch.bmm(xin, p["w_gate"].to(cd).float()).to(cd))
    h = h * torch.bmm(xin, p["w_up"].to(cd).float()).to(cd)
    return torch.bmm(h.float(), p["w_down"].to(cd).float())


def _moe_combine(out_e, dest, w):
    """Each token's gate-weighted sum of its picks' expert outputs ->
    (B·S, D) float32."""
    e, slots, d = out_e.shape
    flat = out_e.reshape(e * slots, d)
    rows = flat[dest.clamp(max=e * slots - 1).reshape(-1)]
    return (rows.view(*dest.shape, d) * w).sum(dim=1)
