"""Sequence-mixing blocks with linear-time state: Mamba2 (SSD), mLSTM,
sLSTM, for the prefill and for one decode step.  The port's counterpart
of ``repro.models.ssm`` and of the two decode steps ``repro`` keeps in
``repro/models/transformer.py`` (``_mlstm_decode``, ``_slstm_decode``).

Mamba2 and mLSTM are both gated linear recurrences

    H_t = a_t · H_{t-1} + B_t ⊗ X_t,      y_t = C_t · H_t

computed chunk by chunk (:func:`_chunked_glr`): inside a chunk two batched
products with a masked decay; across chunks a Python loop of S/chunk
steps.  They stay torch products and elementwise passes, as ``repro``
leaves them to XLA outside any Pallas kernel.  The sLSTM's scalar
recurrence is sequential in time; ``repro`` runs it as a ``lax.scan``,
the port as the ``slstm_scan`` kernel (:func:`repro_torch.kernels.ops.
slstm_scan`: one launch on the card for the whole sequence or a decode
step, the plain Python loop on the CPU).

Every function takes the compute dtype ``cd`` (the rule of
:mod:`repro_torch.models.layers`): matmuls run on ``cd`` operands, and a
product ``repro`` accumulates in float32 runs on the operands upcast to
float32.  The states and the recurrences are float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def softplus(x):
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0), with no
    threshold (``torch.nn.functional.softplus`` returns x above 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _decay(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _chunked_glr(xv, kb, qc, log_a, chunk: int, cd):
    """Chunked gated linear recurrence.

    xv: (B, S, H, P) values (X_t); kb: (B, S, H, N) input maps (B_t);
    qc: (B, S, H, N) output maps (C_t); log_a: (B, S, H) float32 per-step
    log decay (<= 0).  Returns y (B, S, H, P) float32.  S must be a
    multiple of ``chunk``."""
    b, s, h, p = xv.shape
    n = kb.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length S {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk

    def r(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xv, kb, qc, log_a = r(xv), r(kb), r(qc), r(log_a)
    cum = torch.cumsum(log_a, dim=2)                    # (B, nc, L, H)
    total = cum[:, :, -1]                               # (B, nc, H)

    # Intra-chunk: masked, decay-weighted products.  The mask comes after
    # w·decay: above the diagonal li - lj clips to 0, exp gives 1, and the
    # entry must still come out 0.
    decay = _decay(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xv.device))
    w = torch.einsum("bcihn,bcjhn->bcijh", qc.to(F32), kb.to(F32))
    w = torch.where(causal[None, None, :, :, None], w * decay, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(cd).to(F32),
                           xv.to(F32))

    # Chunk summaries and the inter-chunk recurrence.
    tail = _decay(total[:, :, None, :] - cum)           # decay to chunk end
    state_c = torch.einsum("bcjhn,bcjhp->bchnp",
                           (kb.to(F32) * tail[..., None]).to(cd).to(F32),
                           xv.to(F32))                  # (B, nc, H, N, P)
    h_in = torch.empty_like(state_c)                    # state entering chunk
    hprev = torch.zeros((b, h, n, p), dtype=F32, device=xv.device)
    for c in range(nc):
        h_in[:, c] = hprev
        hprev = torch.exp(total[:, c])[..., None, None] * hprev + state_c[:, c]

    head_decay = _decay(cum)                            # decay from chunk start
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           (qc.to(F32) * head_decay[..., None]).to(cd).to(F32),
                           h_in.to(cd).to(F32))
    return (y_intra + y_inter).reshape(b, s, h, p)


def mamba2_block(x, p, cfg: ModelConfig, cd):
    """Mamba2 (SSD) mixer. x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    h, n = cfg.n_heads, cfg.ssm_state
    di = cfg.ssm_expand * d                             # inner width
    hd = di // h
    xc = x.to(cd)
    xv, z = (xc @ p["w_in"].to(cd)).chunk(2, dim=-1)    # (B, S, di) each
    kb, qc = (xc @ p["w_bc"].to(cd)).chunk(2, dim=-1)   # (B, S, N) each
    dt = softplus((xc @ p["w_dt"].to(cd)).to(F32) + p["dt_bias"])   # (B, S, H)
    log_a = -dt * torch.exp(p["log_A"])                 # A > 0

    xv = xv.reshape(b, s, h, hd)
    kbh = kb[:, :, None, :].expand(b, s, h, n) * dt[..., None].to(cd)
    qch = qc[:, :, None, :].expand(b, s, h, n)
    y = _chunked_glr(xv, kbh, qch, log_a, cfg.ssm_chunk, cd)
    y = y + xv.to(F32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, di).to(cd) * F.silu(z)
    return (y @ p["w_out"].to(cd)).to(x.dtype)


def mamba2_decode(x, p, cfg: ModelConfig, state, cd):
    """One Mamba2 step. x: (B, 1, D); state (B, H, N, hd) float32 ->
    (out (B, 1, D), new state)."""
    b, _, d = x.shape
    h, n = cfg.n_heads, cfg.ssm_state
    di = cfg.ssm_expand * d
    hd = di // h
    xc = x[:, 0].to(cd)
    xv, z = (xc @ p["w_in"].to(cd)).chunk(2, dim=-1)
    kb, qc = (xc @ p["w_bc"].to(cd)).chunk(2, dim=-1)
    dt = softplus((xc @ p["w_dt"].to(cd)).to(F32) + p["dt_bias"])   # (B, H)
    a = torch.exp(-dt * torch.exp(p["log_A"]))

    xv = xv.reshape(b, h, hd).to(F32)
    kbh = kb[:, None, :].to(F32) * dt[..., None]        # (B, H, N)
    state = a[..., None, None] * state + kbh[..., None] * xv[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp",
                     qc[:, None, :].expand(b, h, n).to(F32), state)
    y = y + xv * p["D"][None, :, None]
    y = y.reshape(b, di).to(cd) * F.silu(z)
    return (y @ p["w_out"].to(cd)).to(x.dtype)[:, None], state


def _mlstm_gates(xc, p, cd):
    gates = (xc @ p["w_if"].to(cd)).to(F32)             # (..., 2H)
    return gates.chunk(2, dim=-1)                       # i_pre, f_pre


def mlstm_block(x, p, cfg: ModelConfig, cd):
    """xLSTM mLSTM mixer (matrix memory, exp input gate, sigmoid forget).
    x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xc = x.to(cd)
    q = (xc @ p["wq"].to(cd)).reshape(b, s, h, hd)
    k = (xc @ p["wk"].to(cd)).reshape(b, s, h, hd) / math.sqrt(float(hd))
    v = (xc @ p["wv"].to(cd)).reshape(b, s, h, hd)
    i_pre, f_pre = _mlstm_gates(xc, p, cd)
    log_f = -softplus(-f_pre)                           # log sigmoid
    i_gate = torch.exp(torch.clamp(i_pre, max=10.0))

    kv = k * i_gate[..., None].to(cd)
    y = _chunked_glr(v, kv, q, log_f, cfg.ssm_chunk, cd)            # numerator
    ones = torch.ones((b, s, h, 1), dtype=cd, device=x.device)
    nrm = _chunked_glr(ones, kv, q, log_f, cfg.ssm_chunk, cd)       # normaliser
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = y.reshape(b, s, d).to(cd) * F.silu(xc @ p["w_z"].to(cd))
    return (y @ p["w_out"].to(cd)).to(x.dtype)


def mlstm_decode(x, p, cfg: ModelConfig, C, n, cd):
    """One mLSTM step. x: (B, 1, D); C (B, H, hd, hd), n (B, H, hd)
    float32 -> (out (B, 1, D), new C, new n)."""
    b, _, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xc = x[:, 0].to(cd)
    q = (xc @ p["wq"].to(cd)).reshape(b, h, hd).to(F32)
    k = (xc @ p["wk"].to(cd)).reshape(b, h, hd).to(F32) / math.sqrt(hd)
    v = (xc @ p["wv"].to(cd)).reshape(b, h, hd).to(F32)
    i_pre, f_pre = _mlstm_gates(xc, p, cd)
    f = torch.sigmoid(f_pre)
    i = torch.exp(torch.clamp(i_pre, max=10.0))
    C = (f[..., None, None] * C
         + i[..., None, None] * k[..., :, None] * v[..., None, :])
    n = f[..., None] * n + i[..., None] * k
    num = torch.einsum("bhk,bhkp->bhp", q, C)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", q, n).abs()[..., None],
                      min=1.0)
    y = (num / den).reshape(b, d).to(cd)
    y = y * F.silu(xc @ p["w_z"].to(cd))
    return (y @ p["w_out"].to(cd)).to(x.dtype)[:, None], C, n


def _slstm_gates(xc, p, cd):
    return ((xc @ p["w_gates"].to(cd)).to(F32) + p["b_gates"]).contiguous()


def slstm_block(x, p, cfg: ModelConfig, cd):
    """xLSTM sLSTM: scalar memory, exponential gating, one ``slstm_scan``
    over the sequence from c = n = 0, m = -1e30. x: (B, S, D) -> (B, S, D)."""
    b, _, d = x.shape
    gates = _slstm_gates(x.to(cd), p, cd)               # (B, S, 4D)
    zero = torch.zeros((b, d), dtype=F32, device=x.device)
    m0 = torch.full((b, d), -1e30, dtype=F32, device=x.device)
    hs, _, _, _ = ops.slstm_scan(gates, zero, zero, m0)
    return (hs.to(cd) @ p["w_out"].to(cd)).to(x.dtype)


def slstm_decode(x, p, cfg: ModelConfig, state: dict, cd):
    """One sLSTM step, an ``slstm_scan`` of S = 1 from the cached state.
    x: (B, 1, D); state {"c", "n", "m"} (B, D) float32 -> (out (B, 1, D),
    new state)."""
    gates = _slstm_gates(x.to(cd), p, cd)               # (B, 1, 4D)
    hs, c, n, m = ops.slstm_scan(gates, state["c"], state["n"], state["m"])
    y = (hs[:, 0].to(cd) @ p["w_out"].to(cd)).to(x.dtype)[:, None]
    return y, {"c": c, "n": n, "m": m}
