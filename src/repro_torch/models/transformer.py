"""Model assembly for the attention family: parameters, the prefill
forward, logits, KV caches and one decode step.  The port's counterpart of
``repro.models.transformer`` for the ``attn`` and ``moe`` layer kinds; the
other kinds (mamba2, mlstm, slstm, shared_attn) raise
``NotImplementedError``.

Parameters are a dict of float32 tensors: ``embed`` (padded vocab, D),
``final_norm`` (D,), ``lm_head`` when the embeddings are not tied,
``frontend_proj`` (D, D) for the audio and image stub frontends, and
``layers``, one dict per layer in execution order (segment by segment,
repetition by repetition, spec by spec — the order of ``repro``'s scans).
``repro`` stacks a segment's layers on a leading ``reps`` axis;
:func:`repro_torch.convert.lm_params_from_numpy` unstacks them.  The
segments run as a Python loop, not a scan.

``compute_dtype`` (default: bfloat16 on the card, float32 on the CPU) is
the dtype of the matmuls and of the residual stream; it replaces
``repro``'s ``REPRO_COMPUTE_DTYPE``.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig

PDTYPE = torch.float32   # parameter dtype
ATTN_KINDS = ("attn", "moe")
_ZERO_INIT = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")


def _check_kind(spec: LayerSpec) -> None:
    if spec.kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"layer kind {spec.kind!r} is not ported (ROADMAP.md Queue 1 "
            f"item 3); the port runs {ATTN_KINDS}")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Every layer's spec in execution order."""
    return [spec for seg in cfg.segments for _ in range(seg.reps)
            for spec in seg.layers]


def layer_shapes(cfg: ModelConfig, kind: str) -> dict:
    _check_kind(LayerSpec(kind))
    d, hd = cfg.d_model, cfg.hd
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shp = {"ln1": (d,), "ln2": (d,),
           "wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
           "wo": (hq * hd, d)}
    if cfg.qkv_bias:
        shp.update({"bq": (hq * hd,), "bk": (hkv * hd,), "bv": (hkv * hd,)})
    if kind == "moe":
        e = cfg.n_experts
        shp.update({"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
                    "w_down": (e, f, d)})
    elif cfg.mlp in ("swiglu", "geglu"):
        shp.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    else:
        shp.update({"w_up": (d, f), "w_down": (f, d)})
    return shp


def tree_shapes(cfg: ModelConfig) -> dict:
    tree: dict = {"embed": (cfg.padded_vocab, cfg.d_model),
                  "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.padded_vocab, cfg.d_model)
    if cfg.modality != "text":
        tree["frontend_proj"] = (cfg.d_model, cfg.d_model)   # stub projection
    tree["layers"] = [layer_shapes(cfg, spec.kind) for spec in layer_specs(cfg)]
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random float32 parameters with ``repro``'s distributions: norms and
    biases 0, embeddings N(0, 0.02²), every matrix N(0, 1/fan_in), drawn
    from ``generator`` (which must live on ``device``) leaf by leaf."""
    dev = resolve_device(device)

    def make(name, shp):
        if name in _ZERO_INIT:
            return torch.zeros(shp, dtype=PDTYPE, device=dev)
        x = torch.randn(shp, generator=generator, dtype=PDTYPE, device=dev)
        if name in ("embed", "lm_head"):
            return x.mul_(0.02)
        return x.div_(math.sqrt(shp[-2] if len(shp) >= 2 else shp[-1]))

    tree = tree_shapes(cfg)
    params = {n: make(n, s) for n, s in tree.items() if n != "layers"}
    params["layers"] = [{n: make(n, s) for n, s in lp.items()}
                        for lp in tree["layers"]]
    return params


def tree_to(tree, device):
    """A parameter or cache tree with every tensor moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return [tree_to(v, device) for v in tree]


def _cd(params, compute_dtype):
    return L.compute_dtype(params["embed"].device, compute_dtype)


def _mlp(x, p, spec: LayerSpec, cfg: ModelConfig, cd):
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.kind == "moe":
        return L.moe_mlp(h, p, cfg, cd)
    return L.dense_mlp(h, p, cfg, cd)


def forward(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
            compute_dtype=None):
    """tokens: (B, S) integer -> final hidden states (B, S, D) in the
    compute dtype.

    frontend_embeds: (B, S_fe, D), the stub frontend's prefix (audio
    frames, image patches): ``frontend_embeds @ frontend_proj`` replaces
    the first S_fe token embeddings (early fusion)."""
    cd = _cd(params, compute_dtype)
    x = params["embed"][tokens.long()].to(cd) * math.sqrt(cfg.d_model)
    if frontend_embeds is not None:
        fe = frontend_embeds.to(cd) @ params["frontend_proj"].to(cd)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    eps = cfg.norm_eps
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        _check_kind(spec)
        x = x + L.attention(L.rms_norm(x, p["ln1"], eps), p, cfg, spec.window, cd)
        x = x + _mlp(x, p, spec, cfg, cd)
    return L.rms_norm(x, params["final_norm"], eps)


def logits(params, h, cfg: ModelConfig, *, compute_dtype=None):
    """(B, S, D) hidden states -> (B, S, padded vocab) logits."""
    cd = _cd(params, compute_dtype)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return h.to(cd) @ head.to(cd).T


def cache_len(spec: LayerSpec, s_max: int) -> int:
    if spec.kind in ATTN_KINDS and spec.window > 0:
        return min(spec.window, s_max)   # rotating window cache
    return s_max


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device="cuda",
               compute_dtype=None) -> list[dict]:
    """One {"k", "v"} pair of zeroed (B, L_c, Hkv, hd) caches per layer:
    in the compute dtype, or with ``cfg.kv_dtype == "int8"`` each a dict
    of int8 codes "q" and float32 scales "s" (B, L_c, Hkv, 1)."""
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
    dev = resolve_device(device)
    cd = L.compute_dtype(dev, compute_dtype)

    def one(shp):
        if cfg.kv_dtype == "int8":
            return {"q": torch.zeros(shp, dtype=torch.int8, device=dev),
                    "s": torch.zeros(shp[:-1] + (1,), dtype=torch.float32,
                                     device=dev)}
        return torch.zeros(shp, dtype=cd, device=dev)

    out = []
    for spec in layer_specs(cfg):
        _check_kind(spec)
        shp = (batch, cache_len(spec, s_max), cfg.n_kv_heads, cfg.hd)
        out.append({"k": one(shp), "v": one(shp)})
    return out


def decode_forward(params, cache, token, pos: int, cfg: ModelConfig, *,
                   compute_dtype=None):
    """token: (B, 1) integer at absolute position ``pos``.  Returns
    (logits (B, 1, vocab), cache); the caches are updated in place."""
    cd = _cd(params, compute_dtype)
    pos = int(pos)
    x = params["embed"][token.long()].to(cd) * math.sqrt(cfg.d_model)
    eps = cfg.norm_eps
    for spec, p, c in zip(layer_specs(cfg), params["layers"], cache):
        _check_kind(spec)
        h, c["k"], c["v"] = L.decode_attention(
            L.rms_norm(x, p["ln1"], eps), p, cfg, spec.window, c["k"], c["v"],
            pos, cd)
        x = x + h
        x = x + _mlp(x, p, spec, cfg, cd)
    h = L.rms_norm(x, params["final_norm"], eps)
    return logits(params, h, cfg, compute_dtype=cd)[..., :cfg.vocab], cache
