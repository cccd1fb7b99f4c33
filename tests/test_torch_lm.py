"""The port's LM serving path (``repro_torch.models``, ``repro_torch.serve.lm``)
against ``repro`` on the CPU, float32 on both sides.

Inputs come from a numpy seed; parameters from ``repro.models.init_params``,
carried across with ``convert.lm_params_from_numpy``.  Tolerances:
2e-5 for the attention kernel's plain version (as ``tests/test_kernels.py``
holds the Pallas kernel to ``repro``'s oracle), 1e-5 for single layers,
1e-4 for whole forwards, prefill logits and decode logits (float32 sums in
another order through a few layers); greedy tokens identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as repro_smoke  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import (decode_forward as j_decode, forward as j_forward,  # noqa: E402
                          init_cache as j_init_cache, init_params as j_init)
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import _logits as j_logits  # noqa: E402
from repro.serve.lm import ServeLoop as JServeLoop  # noqa: E402
from repro.serve.lm import make_prefill_fn as j_prefill_fn  # noqa: E402

from repro_torch.configs import gemma3_1b, registry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig, Segment  # noqa: E402
from repro_torch.models.transformer import (decode_forward, forward,  # noqa: E402
                                            init_cache, init_params, logits)
from repro_torch.serve.lm import ServeLoop, make_prefill_fn  # noqa: E402

F32 = torch.float32


def _port_config(jcfg) -> ModelConfig:
    """A repro ModelConfig rebuilt field by field as the port's."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "segments"}
    segs = tuple(Segment(reps=s.reps, layers=tuple(
        LayerSpec(sp.kind, sp.window) for sp in s.layers))
        for s in jcfg.segments)
    return ModelConfig(segments=segs, **fields)


def _setup(arch: str, seed: int = 3):
    jcfg = repro_smoke(arch)
    cfg = _port_config(jcfg)
    jparams = j_init(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, lm_params_from_numpy(tree, cfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------- (a) kernel

@pytest.mark.parametrize("bh,sq,sk,hd", [(2, 64, 64, 32), (3, 200, 136, 64),
                                         (4, 256, 256, 128)])
@pytest.mark.parametrize("window", [-1, 48])
def test_flash_attention_matches_repro(bh, sq, sk, hd, window):
    rng = np.random.default_rng(bh * sq + hd)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k = rng.standard_normal((bh, sk, hd)).astype(np.float32)
    v = rng.standard_normal((bh, sk, hd)).astype(np.float32)
    want = np.asarray(jref.flash_attention(q, k, v, window))
    pallas = np.asarray(jops.flash_attention(q, k, v, window=window,
                                             sq_blk=64, sk_blk=64,
                                             interpret=True))
    ops.reset_counts()
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    plain = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window)
    assert ops.PLAIN["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention"] == 0
    for out in (got, plain):
        assert out.shape == (bh, sq, hd) and out.dtype == F32
        _close(out, want, 2e-5)
        _close(out, pallas, 2e-5)
    if sq > sk and window > 0:
        # rows past sk + window see no key: exactly 0
        assert bool((got[:, sk + window - 1:] == 0).all())


def test_flash_attention_sk_real_matches_pallas():
    """Keys at or past sk_real are masked whatever they hold (the padded
    keys of repro's ops wrapper)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 128, 32)).astype(np.float32)
    k = rng.standard_normal((2, 128, 32)).astype(np.float32)
    v = rng.standard_normal((2, 128, 32)).astype(np.float32)
    k[:, 90:] *= 50                                 # masked: must not show
    v[:, 90:] *= 50
    want = np.asarray(flash_attention_pallas(q, k, v, window=20, sq_blk=64,
                                             sk_blk=64, interpret=True,
                                             sk_real=90))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=20, sk_real=90)
    _close(got, want, 2e-5)
    assert bool((got[:, 109:] == 0).all()) and bool((got[:, :109] != 0).any())


def test_flash_attention_validates_operands():
    q = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError, match="q must be"):
        ops.flash_attention(q.double(), q, q)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q, q[:, :, :8], q)
    with pytest.raises(ValueError, match="sk_real"):
        ops.flash_attention(q, q, q, sk_real=9)


# ---------------------------------------------------------------- (b) layers

def test_rms_norm_and_rope_match_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JL.rms_norm(x, scale, 1e-6), 1e-5)
    pos = np.arange(100, 109)[None, :].repeat(2, 0)
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.rope(x, pos, 1e6), 1e-5)


@pytest.mark.parametrize("window", [8, -1])
def test_attention_layer_matches_repro(window):
    jcfg, cfg, jparams, params = _setup("gemma3-1b")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["seg0"]["pos0"])
    x = np.random.default_rng(1).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    want = JL.attention(x, jp, jcfg, window)
    got = L.attention(torch.from_numpy(x), params["layers"][0], cfg, window, F32)
    _close(got, want, 1e-5)
    _close(L.dense_mlp(torch.from_numpy(x), params["layers"][0], cfg, F32),
           JL.dense_mlp(x, jp, jcfg), 1e-5)


# ------------------------------------------------- (c, f) forward and prefill

@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-32b"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_and_prefill_match_repro(arch, use_flash):
    """gemma3 smoke: MQA, window 8 and full, geglu, tied embeddings.
    qwen2.5 smoke: GQA (4 heads, 2 kv), qkv bias, swiglu, an lm_head."""
    jcfg, cfg, jparams, params = _setup(arch)
    toks = _tokens(cfg, 2, 24, seed=5)
    JL.set_use_flash(use_flash)
    try:
        jh = j_forward(jparams, jnp.asarray(toks), jcfg, remat=False)
        jlg = j_prefill_fn(jcfg)(jparams, jnp.asarray(toks))
    finally:
        JL.set_use_flash(False)
    ops.reset_counts()
    h = forward(params, torch.from_numpy(toks), cfg)
    lg = make_prefill_fn(cfg)(params, torch.from_numpy(toks))
    assert ops.PLAIN["flash_attention"] == 2 * cfg.n_layers
    assert h.dtype == F32 and lg.shape == (2, cfg.vocab)
    _close(h, jh, 1e-4)
    _close(lg, jlg, 1e-4)


# ---------------------------------------------------------------- (d) decode

@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-32b"])
def test_decode_matches_repro_and_prefill(arch):
    """Token by token past the 8-slot rotating window of gemma3's local
    layer; each step against repro's decode and against the port's own
    forward over the prefix."""
    jcfg, cfg, jparams, params = _setup(arch)
    b, s = 2, 14
    toks = _tokens(cfg, b, s, seed=6)
    jcache = j_init_cache(jcfg, b, 16)
    cache = init_cache(cfg, b, 16, device="cpu")
    full = logits(params, forward(params, torch.from_numpy(toks), cfg), cfg)
    jstep = jax.jit(lambda p, c, t, i: j_decode(p, c, t, i, jcfg))
    for pos in range(s):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
        lg, cache = decode_forward(params, cache, torch.from_numpy(tok), pos, cfg)
        assert lg.shape == (b, 1, cfg.vocab)
        _close(lg, jlg, 1e-4)
        _close(lg[:, 0], full[:, pos, :cfg.vocab], 1e-4)


# ---------------------------------------------------------------- (e) serve

@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-32b"])
def test_serve_loop_generates_repro_tokens(arch):
    jcfg, cfg, jparams, params = _setup(arch, seed=4)
    prompts = _tokens(cfg, 2, 8, seed=7)
    want = np.asarray(JServeLoop(jcfg, jparams, max_len=32).generate(
        jnp.asarray(prompts), n_new=16))
    got = ServeLoop(cfg, params, max_len=32).generate(torch.from_numpy(prompts),
                                                      n_new=16)
    assert got.dtype == torch.int32 and got.shape == (2, 24)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------- (g) configs and scope

def test_configs_match_repro():
    from repro.configs import gemma3_1b as jg
    from repro.configs.registry import ARCHS

    for name in ("config", "long_context_config", "smoke_config"):
        jcfg = getattr(jg, name)()
        cfg = getattr(gemma3_1b, name)()
        assert cfg == _port_config(jcfg)
        assert cfg.n_params() == jcfg.n_params()
    assert registry.REPRO_ARCHS == ARCHS
    assert gemma3_1b.config().n_params() == 999_812_736


def test_unknown_arch_kind_and_kv_dtype_raise():
    from repro_torch.models.transformer import layer_shapes

    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-9")
    cfg = gemma3_1b.smoke_config()
    with pytest.raises(ValueError, match="unknown layer kind"):
        layer_shapes(cfg, "rwkv")
    cfg = dataclasses.replace(cfg, kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        init_cache(cfg, 1, 8, device="cpu")


def test_lm_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU rule cannot show")
    cfg = gemma3_1b.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy({}, cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert len(params["layers"]) == cfg.n_layers
