"""Model assembly: parameters, the prefill forward, logits, the decode
caches and one decode step for every layer kind of ``repro``'s ten archs.
The port's counterpart of ``repro.models.transformer``.

Layer kinds: ``attn`` and ``moe`` (attention + dense or MoE MLP,
:mod:`repro_torch.models.layers`), ``mamba2``, ``mlstm`` and ``slstm``
(:mod:`repro_torch.models.ssm`), and ``shared_attn``, zamba2's attention +
dense MLP block whose one parameter set serves every invocation.

Parameters are a dict of float32 tensors: ``embed`` (padded vocab, D),
``final_norm`` (D,), ``lm_head`` when the embeddings are not tied,
``frontend_proj`` (D, D) for the audio and image stub frontends,
``shared`` for an arch with ``shared_attn`` layers, and ``layers``, one
dict per layer in execution order (segment by segment, repetition by
repetition, spec by spec — the order of ``repro``'s scans).  Every
``shared_attn`` entry of ``layers`` is the ``shared`` dict itself, not a
copy.  ``repro`` stacks a segment's layers on a leading ``reps`` axis and
keeps ``shared`` apart; :func:`repro_torch.convert.lm_params_from_numpy`
unstacks them.  The segments run as a Python loop, not a scan.

The decode cache is one dict per layer: a K/V pair for each attention
invocation (``shared_attn`` ones included: they share parameters, not
caches), ``state`` for mamba2, ``C`` and ``n`` for mLSTM, ``c``, ``n`` and
``m`` for sLSTM (float32).  A decode step writes each layer's new cache
entries into its dict.

``compute_dtype`` (default: bfloat16 on the card, float32 on the CPU) is
the dtype of the matmuls and of the residual stream; it replaces
``repro``'s ``REPRO_COMPUTE_DTYPE``.

Training: :func:`lm_loss` is ``repro``'s mean next-token cross-entropy,
the unembedding and softmax run in sequence chunks so the (B, S, V)
logits never exist; its gradient is autograd's, through the kernels'
autograd Functions on the card (``kernels/ops``).  :func:`forward` runs
each layer under non-reentrant ``torch.utils.checkpoint`` when ``remat``
and grad mode are on (``repro``'s ``jax.checkpoint`` of a segment's scan
body): a layer's activations live only during its own forward and its
recompute.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import LayerSpec, ModelConfig

PDTYPE = torch.float32   # parameter dtype
ATTN_KINDS = ("attn", "moe", "shared_attn")
SSM_KINDS = ("mamba2", "mlstm", "slstm")
_ZERO_INIT = ("ln1", "ln2", "final_norm", "bq", "bk", "bv", "b_gates",
              "log_A")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Every layer's spec in execution order."""
    return [spec for seg in cfg.segments for _ in range(seg.reps)
            for spec in seg.layers]


def layer_shapes(cfg: ModelConfig, kind: str) -> dict:
    d, hd, n = cfg.d_model, cfg.hd, cfg.ssm_state
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    if kind == "mamba2":
        di = cfg.ssm_expand * d                  # inner width
        return {"ln1": (d,), "w_in": (d, 2 * di), "w_bc": (d, 2 * n),
                "w_dt": (d, hq), "dt_bias": (hq,), "log_A": (hq,),
                "D": (hq,), "w_out": (di, d)}
    if kind == "mlstm":
        return {"ln1": (d,), "wq": (d, d), "wk": (d, d), "wv": (d, d),
                "w_if": (d, 2 * hq), "w_z": (d, d), "w_out": (d, d)}
    if kind == "slstm":
        return {"ln1": (d,), "w_gates": (d, 4 * d), "b_gates": (4 * d,),
                "w_out": (d, d)}
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
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
    """The parameter tree's shapes.  A ``shared_attn`` layer's entry is
    empty: its shapes stand once, under ``shared``."""
    tree: dict = {"embed": (cfg.padded_vocab, cfg.d_model),
                  "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.padded_vocab, cfg.d_model)
    if cfg.modality != "text":
        tree["frontend_proj"] = (cfg.d_model, cfg.d_model)   # stub projection
    specs = layer_specs(cfg)
    tree["layers"] = [{} if spec.kind == "shared_attn"
                      else layer_shapes(cfg, spec.kind) for spec in specs]
    if any(spec.kind == "shared_attn" for spec in specs):
        tree["shared"] = layer_shapes(cfg, "shared_attn")
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Random float32 parameters with ``repro``'s distributions: norms,
    biases and ``log_A`` 0, ``D`` 1, ``dt_bias`` -2, embeddings
    N(0, 0.02²), every matrix N(0, 1/fan_in), drawn from ``generator``
    (which must live on ``device``) leaf by leaf.  Every ``shared_attn``
    layer gets the one ``shared`` dict."""
    dev = resolve_device(device)

    def make(name, shp):
        if name in _ZERO_INIT:
            return torch.zeros(shp, dtype=PDTYPE, device=dev)
        if name == "D":
            return torch.ones(shp, dtype=PDTYPE, device=dev)
        if name == "dt_bias":
            return torch.full(shp, -2.0, dtype=PDTYPE, device=dev)
        x = torch.randn(shp, generator=generator, dtype=PDTYPE, device=dev)
        if name in ("embed", "lm_head"):
            return x.mul_(0.02)
        return x.div_(math.sqrt(shp[-2] if len(shp) >= 2 else shp[-1]))

    tree = tree_shapes(cfg)
    params = {n: make(n, s) for n, s in tree.items()
              if n not in ("layers", "shared")}
    if "shared" in tree:
        params["shared"] = {n: make(n, s) for n, s in tree["shared"].items()}
    params["layers"] = [
        params["shared"] if spec.kind == "shared_attn"
        else {n: make(n, s) for n, s in lp.items()}
        for spec, lp in zip(layer_specs(cfg), tree["layers"])]
    return params


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a parameter or cache tree (dicts, lists
    and tensors), and the matching nodes of ``rest``.  A dict met twice
    (``shared``) maps once and stays one object."""
    memo: dict = {}

    def go(node, *others):
        if isinstance(node, torch.Tensor):
            return fn(node, *others)
        if isinstance(node, dict):
            if id(node) not in memo:
                memo[id(node)] = {k: go(v, *(o[k] for o in others))
                                  for k, v in node.items()}
            return memo[id(node)]
        if isinstance(node, (list, tuple)):
            return type(node)(go(v, *(o[i] for o in others))
                              for i, v in enumerate(node))
        return node

    return go(tree, *rest)


def tree_leaves(tree) -> list:
    """Each tensor of ``tree`` once, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_from_leaves(template, leaves):
    """``template``'s structure with its tensors replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_to(tree, device):
    """A parameter or cache tree with every tensor moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def _cd(params, compute_dtype):
    return L.compute_dtype(params["embed"].device, compute_dtype)


def _mlp(x, p, spec: LayerSpec, cfg: ModelConfig, cd):
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.kind == "moe":
        return L.moe_mlp(h, p, cfg, cd)
    return L.dense_mlp(h, p, cfg, cd)


def _apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, cd):
    eps = cfg.norm_eps
    h = L.rms_norm(x, p["ln1"], eps)
    if spec.kind == "mamba2":
        return x + S.mamba2_block(h, p, cfg, cd)
    if spec.kind == "mlstm":
        return x + S.mlstm_block(h, p, cfg, cd)
    if spec.kind == "slstm":
        return x + S.slstm_block(h, p, cfg, cd)
    x = x + L.attention(h, p, cfg, spec.window, cd)
    return x + _mlp(x, p, spec, cfg, cd)


def forward(params, tokens, cfg: ModelConfig, *, frontend_embeds=None,
            compute_dtype=None, remat: bool = True):
    """tokens: (B, S) integer -> final hidden states (B, S, D) in the
    compute dtype.  With mamba2 or mLSTM layers S must be a multiple of
    ``cfg.ssm_chunk``.

    frontend_embeds: (B, S_fe, D), the stub frontend's prefix (audio
    frames, image patches): ``frontend_embeds @ frontend_proj`` replaces
    the first S_fe token embeddings (early fusion).

    remat: under grad mode, each layer runs under non-reentrant
    ``torch.utils.checkpoint``, its activations recomputed in the
    backward; without grad mode it changes nothing.  The serving prefill
    asks for none, as ``repro``'s does."""
    cd = _cd(params, compute_dtype)
    x = params["embed"][tokens.long()].to(cd) * math.sqrt(cfg.d_model)
    if frontend_embeds is not None:
        fe = frontend_embeds.to(cd) @ params["frontend_proj"].to(cd)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    remat = remat and torch.is_grad_enabled()
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        if remat:
            x = checkpoint(_apply_layer, x, p, spec, cfg, cd,
                           use_reentrant=False)
        else:
            x = _apply_layer(x, p, spec, cfg, cd)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits(params, h, cfg: ModelConfig, *, compute_dtype=None):
    """(B, S, D) hidden states -> (B, S, padded vocab) logits."""
    cd = _cd(params, compute_dtype)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return h.to(cd) @ head.to(cd).T


def _chunk_loss(h, labels, head, cfg: ModelConfig, cd):
    """Σ (logsumexp - gold logit) over one chunk of positions, float32;
    the padded vocabulary's columns at -1e30."""
    lg = (h.to(cd) @ head.T).float()
    cols = torch.arange(cfg.padded_vocab, device=lg.device)
    lg = torch.where(cols < cfg.vocab, lg, -1e30)
    gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    return torch.sum(torch.logsumexp(lg, dim=-1) - gold)


def lm_loss(params, tokens, labels, cfg: ModelConfig, *,
            loss_chunk: int = 512, frontend_embeds=None, compute_dtype=None):
    """Mean next-token cross-entropy of (B, S) ``labels`` (``repro``'s
    ``lm_loss``): the unembedding and log-sum-exp run over chunks of
    min(loss_chunk, S) positions (S must be a multiple of it), each under
    ``torch.utils.checkpoint``, so only one chunk's (B, chunk, padded
    vocab) logits live at a time, in the forward and again in the
    backward; the chunks' float32 sums add in order, divided by B·S."""
    cd = _cd(params, compute_dtype)
    h = forward(params, tokens, cfg, frontend_embeds=frontend_embeds,
                compute_dtype=cd)
    b, s, _ = h.shape
    c = min(loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {c}")
    head = (params["embed"] if cfg.tie_embeddings else params["lm_head"]).to(cd)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        hh, ll = h[:, i:i + c], labels[:, i:i + c]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_loss, hh, ll, head, cfg, cd,
                              use_reentrant=False)
        else:
            part = _chunk_loss(hh, ll, head, cfg, cd)
        total = total + part
    return total / (b * s)


def cache_len(spec: LayerSpec, s_max: int) -> int:
    if spec.kind in ATTN_KINDS and spec.window > 0:
        return min(spec.window, s_max)   # rotating window cache
    return s_max


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device="cuda",
               compute_dtype=None) -> list[dict]:
    """One zeroed cache dict per layer.  Attention kinds: a {"k", "v"} pair
    of (B, L_c, Hkv, hd) caches in the compute dtype, or with
    ``cfg.kv_dtype == "int8"`` each a dict of int8 codes "q" and float32
    scales "s" (B, L_c, Hkv, 1).  mamba2: "state" (B, H, N, di/H); mLSTM:
    "C" (B, H, p, p) and "n" (B, H, p); sLSTM: "c", "n" and "m" (B, D),
    "m" filled with -1e30 (the empty stabiliser); all float32."""
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
    dev = resolve_device(device)
    cd = L.compute_dtype(dev, compute_dtype)
    d, h = cfg.d_model, cfg.n_heads

    def zeros(*shp, dtype=torch.float32):
        return torch.zeros(shp, dtype=dtype, device=dev)

    def kv(shp):
        if cfg.kv_dtype == "int8":
            return {"q": zeros(*shp, dtype=torch.int8),
                    "s": zeros(*shp[:-1], 1)}
        return zeros(*shp, dtype=cd)

    out = []
    for spec in layer_specs(cfg):
        if spec.kind == "mamba2":
            di = cfg.ssm_expand * d
            out.append({"state": zeros(batch, h, cfg.ssm_state, di // h)})
        elif spec.kind == "mlstm":
            p = d // h
            out.append({"C": zeros(batch, h, p, p), "n": zeros(batch, h, p)})
        elif spec.kind == "slstm":
            out.append({"c": zeros(batch, d), "n": zeros(batch, d),
                        "m": torch.full((batch, d), -1e30, device=dev)})
        else:
            shp = (batch, cache_len(spec, s_max), cfg.n_kv_heads, cfg.hd)
            out.append({"k": kv(shp), "v": kv(shp)})
    return out


def _decode_layer(x, p, c: dict, spec: LayerSpec, cfg: ModelConfig, pos: int,
                  cd):
    """One layer of a decode step; writes the layer's new cache entries
    into ``c``."""
    eps = cfg.norm_eps
    h = L.rms_norm(x, p["ln1"], eps)
    if spec.kind == "mamba2":
        out, c["state"] = S.mamba2_decode(h, p, cfg, c["state"], cd)
        return x + out
    if spec.kind == "mlstm":
        out, c["C"], c["n"] = S.mlstm_decode(h, p, cfg, c["C"], c["n"], cd)
        return x + out
    if spec.kind == "slstm":
        out, new = S.slstm_decode(h, p, cfg, c, cd)
        c.update(new)
        return x + out
    out, c["k"], c["v"] = L.decode_attention(h, p, cfg, spec.window, c["k"],
                                             c["v"], pos, cd)
    x = x + out
    return x + _mlp(x, p, spec, cfg, cd)


def decode_forward(params, cache, token, pos: int, cfg: ModelConfig, *,
                   compute_dtype=None):
    """token: (B, 1) integer at absolute position ``pos``.  Returns
    (logits (B, 1, vocab), cache); the cache's dicts are updated in
    place."""
    cd = _cd(params, compute_dtype)
    pos = int(pos)
    x = params["embed"][token.long()].to(cd) * math.sqrt(cfg.d_model)
    for spec, p, c in zip(layer_specs(cfg), params["layers"], cache):
        x = _decode_layer(x, p, c, spec, cfg, pos, cd)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits(params, h, cfg, compute_dtype=cd)[..., :cfg.vocab], cache
