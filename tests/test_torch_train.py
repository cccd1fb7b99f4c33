"""The port's training path against ``repro`` on the CPU: ``lm_loss`` and
its gradients for every arch, the plain backward functions of the two
hand-written kernels (``kernels/ref.py``: ``flash_attention_bwd``,
``slstm_scan_bwd``), AdamW, microbatching, the train step, the training
launcher's resume, and the clustering job configs.

Inputs come from numpy seeds; parameters from ``repro.models.init_params``
carried across with ``convert.lm_params_from_numpy``, gradients back with
``convert.lm_params_to_numpy``.  Tolerances: the loss and every gradient
leaf within 1e-4 of ``jax.value_and_grad(repro.models.lm_loss)`` (each
leaf relative to its largest magnitude: float32 sums in another order);
the plain backward functions within 1e-5 of ``jax.vjp`` and of autograd;
one AdamW step within 1e-6; microbatches 4 against 1 as
``tests/test_models.py`` holds ``repro`` (rtol 1e-4, atol 1e-5); one train
step within 1e-4; a resumed training run bit for bit the uninterrupted
one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import nyt1m as j_nyt1m  # noqa: E402
from repro.configs import pubmed8m as j_pubmed8m  # noqa: E402
from repro.configs import smoke_config as repro_smoke  # noqa: E402
from repro.data import make_corpus as j_make_corpus  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.train import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import adamw_update as j_adamw_update  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from repro_torch.configs import nyt1m, pubmed8m, registry  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 adamw_state_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.data import make_corpus  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402
from repro_torch.train import (AdamWConfig, TrainConfig,  # noqa: E402
                               adamw_init, adamw_update, make_train_step)
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402

B, S, LOSS_CHUNK = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (small tensors;
    the suite's workers would oversubscribe the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pairs(want, got, path=()):
    """(path, repro leaf, port leaf) over ``repro``'s nested dict."""
    if isinstance(want, dict):
        for key in want:
            yield from _pairs(want[key], got[key], path + (key,))
    else:
        yield path, np.asarray(want), np.asarray(got)


def _close_leaves(want, got, tol):
    """Every leaf within ``tol`` relative and ``tol`` of its largest
    magnitude."""
    for path, w, g in _pairs(want, got):
        assert w.shape == g.shape, path
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(float(np.abs(w).max()),
                                                  1e-30),
                                   err_msg="/".join(path))


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    fe = (rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32)
          if cfg.modality != "text" else None)
    return toks, np.roll(toks, -1, axis=1), fe


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCHS)
def test_lm_loss_and_grads_equal_repro(arch):
    """The loss and every gradient leaf within 1e-4 of
    jax.value_and_grad(repro.models.lm_loss): two loss chunks, a frontend
    prefix for the audio and image archs."""
    jcfg, cfg = repro_smoke(arch), registry.smoke_config(arch)
    jparams = j_init(jcfg, jax.random.PRNGKey(3))
    toks, labels, fe = _batch(cfg, 5)
    jfe = None if fe is None else jnp.asarray(fe)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: j_lm_loss(p, toks, labels, jcfg, loss_chunk=LOSS_CHUNK,
                            frontend_embeds=jfe))(jparams)
    params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
    live = tree_map(lambda t: t.requires_grad_(), params)
    loss = lm_loss(live, torch.from_numpy(toks), torch.from_numpy(labels),
                   cfg, loss_chunk=LOSS_CHUNK,
                   frontend_embeds=None if fe is None else torch.from_numpy(fe))
    loss.backward()
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, live)
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        1e-4 * abs(float(want_loss))
    _close_leaves(_np(want_grads), lm_params_to_numpy(grads, cfg), 1e-4)


def test_lm_loss_without_remat_and_unchunked_equal(monkeypatch):
    """remat changes the loss's arithmetic nowhere (the same loss and
    gradients bit for bit without it), one chunk gives the same loss to
    rounding, and S not a multiple of the chunk raises."""
    from repro_torch.models import transformer as T

    cfg = registry.smoke_config("zamba2-2.7b")
    params = lm_params_from_numpy(
        _np(j_init(repro_smoke("zamba2-2.7b"), jax.random.PRNGKey(4))), cfg,
        device="cpu")
    toks, labels, _ = _batch(cfg, 6)
    t, lb = torch.from_numpy(toks), torch.from_numpy(labels)
    forward = T.forward
    outs = []
    for chunk, remat in ((LOSS_CHUNK, True), (LOSS_CHUNK, False), (S, True)):
        monkeypatch.setattr(T, "forward",
                            lambda *a, _r=remat, **k: forward(*a, **k,
                                                              remat=_r))
        live = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
        loss = lm_loss(live, t, lb, cfg, loss_chunk=chunk)
        outs.append((loss, torch.autograd.grad(loss, tree_leaves(live))))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert abs(float(outs[0][0]) - float(outs[2][0])) <= 1e-6
    long_t = torch.cat([t, t[:, :16]], dim=1)              # S 48
    with pytest.raises(ValueError, match="loss chunk"):
        lm_loss(params, long_t, long_t, cfg, loss_chunk=32)


def test_serving_prefill_checkpoints_no_layer(monkeypatch):
    """The serving prefill asks for no remat, as ``repro``'s does: under
    grad mode it calls ``torch.utils.checkpoint`` never, where ``lm_loss``
    calls it once a layer and once a loss chunk."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.lm import make_prefill_fn

    cfg = registry.smoke_config("gemma3-1b")
    params = lm_params_from_numpy(
        _np(j_init(repro_smoke("gemma3-1b"), jax.random.PRNGKey(5))), cfg,
        device="cpu")
    toks, labels, _ = _batch(cfg, 7)
    t, lb = torch.from_numpy(toks), torch.from_numpy(labels)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return T.torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    assert torch.is_grad_enabled()
    want = T.forward(params, t, cfg, remat=False)
    got = make_prefill_fn(cfg)(params, t)
    assert calls == []
    assert torch.equal(got, T.logits(params, want[:, -1:], cfg)[:, 0,
                                                                :cfg.vocab])
    lm_loss(params, t, lb, cfg, loss_chunk=LOSS_CHUNK)
    assert calls == (["_apply_layer"] * cfg.n_layers
                     + ["_chunk_loss"] * (S // LOSS_CHUNK))


# ---------------------------------------------------------------------------
# The plain backward functions
# ---------------------------------------------------------------------------

# (BH, Sq, Sk, hd, window, sk_real): full causal, a window at hd 80, and a
# ragged case whose rows 47-59 see no key (keys >= 38 masked).
ATTN_CASES = [(3, 40, 40, 16, -1, 40), (2, 50, 50, 80, 12, 50),
              (3, 60, 45, 32, 10, 38)]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_bwd_equals_jax_vjp(case):
    """ref.flash_attention_bwd against jax.vjp of repro's _attn_core (keys
    at or past sk_real given positions no query reaches; rows with no live
    key zeroed, the port's rule) and against autograd through
    ref.flash_attention, at 1e-5."""
    bh, sq, sk, hd, window, sk_real = case
    rng = np.random.default_rng(sum(case[:4]))
    q, k, v = (rng.standard_normal((bh, n, hd)).astype(np.float32)
               for n in (sq, sk, sk))
    do = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    q_pos = jnp.arange(sq)
    k_pos = jnp.where(jnp.arange(sk) < sk_real, jnp.arange(sk), 10 ** 6)
    live = np.asarray(ref.band_mask(sq, sk, window, sk_real, "cpu").any(1))

    def attn(qq, kk, vv):
        out = JL._attn_core(qq[:, :, None, None], kk[:, :, None],
                            vv[:, :, None], q_pos, k_pos, window, hd)
        return jnp.where(live[None, :, None], out[:, :, 0, 0], 0.0)

    out, vjp = jax.vjp(attn, q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention(tq, tk, tv, window, sk_real, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.isinf(lse[:, ~torch.from_numpy(live)]).all())
    got = ref.flash_attention_bwd(tq, tk, tv, lse, tdo, window, sk_real)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(ref.flash_attention(*xs, window, sk_real), xs,
                               tdo)
    for g, w, a in zip(got, want, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    if sq > sk_real + window - 1 >= 0 and window >= 0:
        assert bool((got[0][:, sk_real + window - 1:] == 0).all())
    assert bool((got[1][:, sk_real:] == 0).all())


def _jax_slstm_gates_grad(gates, dhs):
    """jax.vjp of repro's slstm_block scan from the zero state, for the
    gates: x one-hot rows pick the gates out of w_gates (x[b, t] =
    e_{b·S + t}, b_gates 0, w_out the identity), so the vjp's w_gates rows
    are the gates' gradient (float32 compute, the one-hot products
    exact)."""
    b, s, d4 = gates.shape
    d = d4 // 4
    assert b * s <= d
    x = np.zeros((b, s, d), np.float32)
    for bi in range(b):
        for t in range(s):
            x[bi, t, bi * s + t] = 1.0
    w = np.zeros((d, d4), np.float32)
    w[:b * s] = gates.reshape(b * s, d4)
    p = {"w_out": jnp.eye(d, dtype=jnp.float32),
         "b_gates": jnp.zeros((d4,), jnp.float32)}
    cfg = repro_smoke("xlstm-125m")
    hs, vjp = jax.vjp(lambda ww: JS.slstm_block(jnp.asarray(x),
                                               {**p, "w_gates": ww}, cfg),
                      jnp.asarray(w))
    (dw,) = vjp(jnp.asarray(dhs))
    return np.asarray(hs), np.asarray(dw)[:b * s].reshape(b, s, d4)


def _zero_state(b, d):
    z = torch.zeros((b, d))
    return z, z.clone(), torch.full((b, d), -1e30)


@pytest.mark.parametrize("b,s,d", [(2, 3, 8), (2, 12, 24)])
def test_slstm_scan_grads_equal_jax_vjp(b, s, d):
    """From the zero state: autograd through ref.slstm_scan and
    ref.slstm_scan_bwd both within 1e-5 of jax.vjp of repro's scan.  Step 0
    of every such scan has n' == 1 exactly, the tie of max(n', 1); there
    the gates' gradient does not depend on the tie's weight (i reaches the
    output only through m' = i, and its two paths cancel), so this holds
    with either rule: test_slstm_tie_gradient_equals_jax_vjp holds the
    rule itself."""
    rng = np.random.default_rng(b * 100 + s)
    gates = (rng.standard_normal((b, s, 4 * d)) * 2).astype(np.float32)
    dhs = rng.standard_normal((b, s, d)).astype(np.float32)
    want_hs, want = _jax_slstm_gates_grad(gates, dhs)
    g = torch.from_numpy(gates).requires_grad_()
    state = _zero_state(b, d)
    hs = ref.slstm_scan(g, *state)[0]
    np.testing.assert_allclose(hs.detach().numpy(), want_hs, rtol=1e-5,
                               atol=1e-5)
    (auto,) = torch.autograd.grad(hs, g, torch.from_numpy(dhs))
    zeros = torch.zeros((b, d))
    plain = ref.slstm_scan_bwd(g.detach(), *state, torch.from_numpy(dhs),
                               zeros, zeros, zeros)[0]
    np.testing.assert_allclose(auto.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def test_slstm_tie_gradient_equals_jax_vjp():
    """A step from a cached state that lands on n' == 1 exactly (n = 1, f +
    m = m' so f_e = 1, i 100 below: i_e ~ 4e-44), against jax.vjp of
    repro's decode step (``_slstm_decode``, its step with the state as an
    input): the state's and the gates' gradients within 1e-5.  JAX splits
    the tie of max(n', 1) in half; the plain version's torch.maximum does
    the same, where torch.clamp gave n' the whole gradient and dn twice
    JAX's.  Both the plain reverse loop and autograd are held."""
    from repro.models import transformer as JT

    d = 6
    rng = np.random.default_rng(13)
    z, o = (rng.standard_normal((1, 1, d)).astype(np.float32)
            for _ in range(2))
    gates = np.concatenate([z, np.full((1, 1, d), -100.0, np.float32),
                            np.zeros((1, 1, d), np.float32), o], axis=-1)
    c0 = rng.standard_normal((1, d)).astype(np.float32)
    n0, m0 = np.ones((1, d), np.float32), np.zeros((1, d), np.float32)
    dy = rng.standard_normal((1, 1, d)).astype(np.float32)
    cfg = repro_smoke("xlstm-125m")
    p = {"w_gates": jnp.zeros((d, 4 * d)), "w_out": jnp.eye(d)}

    def step(b_gates, c, n, m):
        y, _ = JT._slstm_decode(jnp.zeros((1, 1, d)),
                                {**p, "b_gates": b_gates}, cfg,
                                {"c": c, "n": n, "m": m})
        return y

    _, vjp = jax.vjp(step, jnp.asarray(gates[0, 0]), c0, n0, m0)
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    xs = [torch.from_numpy(a).requires_grad_() for a in (gates, c0, n0, m0)]
    hs, c, n, m = ref.slstm_scan(*xs)
    assert bool((n == 1.0).all())                       # the tie
    auto = torch.autograd.grad(hs, xs, torch.from_numpy(dy))
    zeros = torch.zeros((1, d))
    plain = ref.slstm_scan_bwd(*(x.detach() for x in xs), torch.from_numpy(dy),
                               zeros, zeros, zeros)
    for got in (auto, plain):
        np.testing.assert_allclose(got[0].numpy()[0, 0], want[0], rtol=1e-5,
                                   atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    assert float(want[2].__abs__().max()) > 1e-3        # dn is not ~0


@pytest.mark.parametrize("cached", [False, True])
def test_slstm_scan_bwd_equals_autograd(cached):
    """ref.slstm_scan_bwd against autograd through ref.slstm_scan for
    every input and every output's adjoint (hs and the final c, n, m),
    from the zero state and from a cached one, at 1e-5; and S/2 + S/2
    with the adjoints carried equals one pass bit for bit."""
    b, s, d = 3, 20, 5
    rng = np.random.default_rng(7 + cached)
    gates = torch.from_numpy(
        (rng.standard_normal((b, s, 4 * d)) * 3).astype(np.float32))
    if cached:
        state = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.standard_normal((b, d)), rng.random((b, d)) * 4 + 0.5,
            rng.standard_normal((b, d)) * 3))
    else:
        state = _zero_state(b, d)
    adj = (torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)),
           *(torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
             for _ in range(3)))
    xs = [t.clone().requires_grad_() for t in (gates, *state)]
    auto = torch.autograd.grad(ref.slstm_scan(*xs), xs, adj)
    got = ref.slstm_scan_bwd(gates, *state, *adj)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    h = s // 2
    mid = ref.slstm_scan(gates[:, :h], *state)[1:]
    second = ref.slstm_scan_bwd(gates[:, h:], *mid, adj[0][:, h:], *adj[1:])
    first = ref.slstm_scan_bwd(gates[:, :h], *state, adj[0][:, :h],
                               *second[1:])
    assert torch.equal(torch.cat([first[0], second[0]], dim=1), got[0])
    assert all(torch.equal(a, w) for a, w in zip(first[1:], got[1:]))


# ---------------------------------------------------------------------------
# AdamW, microbatching, the train step
# ---------------------------------------------------------------------------

def _zamba_params(seed):
    jcfg, cfg = repro_smoke("zamba2-2.7b"), registry.smoke_config("zamba2-2.7b")
    return jcfg, cfg, j_init(jcfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_adamw_update_equals_repro(grad_scale):
    """One adamw_update against repro's from the same state (count 4,
    moments drawn from a seed) and the same gradients, unclipped and
    clipped: params, mu, nu, count, grad_norm and lr within 1e-6 (zamba2's
    tree: its shared block is one set of leaves on both sides)."""
    jcfg, cfg, jparams = _zamba_params(8)
    rng = np.random.default_rng(int(grad_scale * 1000))
    draw = lambda p, s=1.0: (rng.standard_normal(np.shape(p)) * s
                             ).astype(np.float32)
    jgrads = jax.tree_util.tree_map(lambda p: draw(p, grad_scale), jparams)
    jopt = {"mu": jax.tree_util.tree_map(lambda p: draw(p, 1e-3), jparams),
            "nu": jax.tree_util.tree_map(lambda p: np.abs(draw(p, 1e-4)),
                                         jparams),
            "count": np.int32(4)}
    jcfg_opt = JAdamWConfig(warmup_steps=10)
    want_p, want_opt, want_m = j_adamw_update(
        jgrads, jax.tree_util.tree_map(jnp.asarray, jopt), jparams, jcfg_opt)
    params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
    grads = lm_params_from_numpy(jgrads, cfg, device="cpu")
    opt = adamw_state_from_numpy(jopt, cfg, device="cpu")
    got_p, got_opt, got_m = adamw_update(grads, opt, params,
                                         AdamWConfig(warmup_steps=10))
    _close_leaves(_np(want_p), lm_params_to_numpy(got_p, cfg), 1e-6)
    got_opt_np = adamw_state_to_numpy(got_opt, cfg)
    for name in ("mu", "nu"):
        _close_leaves(_np(want_opt[name]), got_opt_np[name], 1e-6)
    assert int(got_opt_np["count"]) == int(want_opt["count"]) == 5
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=1e-6)
    assert (float(got_m["grad_norm"]) > 1.0) == (grad_scale > 1.0)


def test_microbatch_equivalence():
    """mb 1 and mb 4 give the same update (tests/test_models.py's check of
    repro, on the port)."""
    cfg = registry.smoke_config("gemma-2b")
    jparams = j_init(repro_smoke("gemma-2b"), jax.random.PRNGKey(3))
    toks, labels, _ = _batch(cfg, 9, b=8, s=16)
    outs = []
    for mb in (1, 4):
        params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
        step = make_train_step(cfg, TrainConfig(microbatches=mb))
        p2, _, m = step(params, adamw_init(params), torch.from_numpy(toks),
                        torch.from_numpy(labels))
        outs.append((p2, float(m["loss"])))
    (pa, la), (pb, lb) = outs
    assert abs(la - lb) < 1e-4
    for xa, xb in zip(tree_leaves(pa), tree_leaves(pb)):
        np.testing.assert_allclose(xa.numpy(), xb.numpy(), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TrainConfig(microbatches=3))(
            pa, adamw_init(pa), torch.from_numpy(toks),
            torch.from_numpy(labels))


@pytest.mark.parametrize("arch,mb", [("zamba2-2.7b", 2),
                                     ("granite-moe-3b-a800m", 1)])
def test_train_step_equals_repro(arch, mb):
    """One make_train_step against repro's jitted one from the same
    parameters, batch and fresh AdamW state (warm-up 1, so the step moves
    the parameters by the full lr): loss, grad_norm and lr within 1e-4
    relative, the parameters within 1e-4, mu and nu (the gradients) within
    1e-4 of each leaf's largest magnitude.  (A parameter's step is lr·g /
    (|g| + eps): for a gradient near 0 its sign, so the step, follows the
    last bits of g.)"""
    jcfg, cfg = repro_smoke(arch), registry.smoke_config(arch)
    jparams = j_init(jcfg, jax.random.PRNGKey(11))
    toks, labels, _ = _batch(cfg, 12, b=4, s=16)
    jstep = jax.jit(j_make_train_step(jcfg, JTrainConfig(
        microbatches=mb, loss_chunk=8,
        optimizer=JAdamWConfig(warmup_steps=1))))
    from repro.train import adamw_init as j_adamw_init

    want_p, want_opt, want_m = jstep(jparams, j_adamw_init(jparams), toks,
                                     labels)
    params = lm_params_from_numpy(_np(jparams), cfg, device="cpu")
    step = make_train_step(cfg, TrainConfig(
        microbatches=mb, loss_chunk=8, optimizer=AdamWConfig(warmup_steps=1)))
    got_p, got_opt, got_m = step(params, adamw_init(params),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(labels))
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=1e-4)
    for path, w, g in _pairs(_np(want_p), lm_params_to_numpy(got_p, cfg)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(path))
    got_opt_np = adamw_state_to_numpy(got_opt, cfg)
    for name in ("mu", "nu"):
        _close_leaves(_np(want_opt[name]), got_opt_np[name], 1e-4)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_train_launcher_resume_equals_uninterrupted(tmp_path):
    """launch/train.py --device cpu --smoke: 4 steps in one run against 2
    steps, a checkpoint, and a second run resumed from it to step 4:
    parameters, AdamW state and the last steps' losses bit for bit."""
    base = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "32", "--checkpoint-every", "2"]
    whole = train_launcher.main(base + ["--steps", "4", "--checkpoint-dir",
                                        str(tmp_path / "a")])
    train_launcher.main(base + ["--steps", "2", "--checkpoint-dir",
                                str(tmp_path / "b")])
    resumed = train_launcher.main(base + ["--steps", "4", "--checkpoint-dir",
                                          str(tmp_path / "b")])
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][2:]]
    cfg = whole["cfg"]
    for a, b in ((lm_params_to_numpy(whole["params"], cfg),
                  lm_params_to_numpy(resumed["params"], cfg)),
                 (adamw_state_to_numpy(whole["opt"], cfg),
                  adamw_state_to_numpy(resumed["opt"], cfg))):
        for path, x, y in _pairs(a, b):
            np.testing.assert_array_equal(x, y, err_msg="/".join(path))
    assert int(whole["opt"]["count"]) == int(resumed["opt"]["count"]) == 4
    assert all(np.isfinite(h["loss"]) for h in whole["history"])


def test_train_launcher_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train_launcher.main(["--arch", "gemma3-1b", "--smoke", "--steps",
                             "1"])


# ---------------------------------------------------------------------------
# The clustering job configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod,jmod", [(nyt1m, j_nyt1m),
                                      (pubmed8m, j_pubmed8m)])
def test_job_configs_equal_repro(mod, jmod):
    """config() and reduced() field for field repro's (the corpus spec as
    a dict), and kept out of the LM registry."""
    for fn in ("config", "reduced"):
        got, want = getattr(mod, fn)(), getattr(jmod, fn)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert mod.reduced(seed=3).corpus.seed == 3
    assert mod.config().name not in registry.ARCHS


@pytest.mark.parametrize("mod,jmod", [(nyt1m, j_nyt1m),
                                      (pubmed8m, j_pubmed8m)])
def test_reduced_job_corpus_equals_repro(mod, jmod):
    """reduced()'s corpus through the port's make_corpus against repro's:
    ids, nnz, df, the term permutation and topics bit for bit; the tf-idf
    values within 1e-6 (their log, sums of squares and square roots round
    differently in torch and XLA, up to 3e-7: tests/test_torch_data.py's
    bar)."""
    jd, jdf, jperm, jt = j_make_corpus(jmod.reduced().corpus)
    td, tdf, tperm, tt = make_corpus(mod.reduced().corpus, device="cpu")
    np.testing.assert_array_equal(np.asarray(jd.ids), td.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jd.nnz), td.nnz.numpy())
    np.testing.assert_array_equal(np.asarray(jdf), tdf.numpy())
    np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_allclose(np.asarray(jd.vals), td.vals.numpy(), rtol=0,
                               atol=1e-6)
