"""The seven attention-family archs that joined gemma3-1b in the port
(dense: gemma-2b, qwen1.5-32b, qwen2.5-32b; MoE: granite-moe-3b-a800m,
mixtral-8x22b; stub frontends: musicgen-large, chameleon-34b) against
``repro`` on the CPU, float32 on both sides, on their smoke configs.

Parameters come from ``repro.models.init_params`` and cross with
``convert.lm_params_from_numpy``; tokens from a numpy seed.  Tolerances:
1e-4 for prefill and decode logits (float32 sums in another order through
a few layers), greedy tokens identical.  The int8 KV cache: its codes
equal ``repro``'s but where the unrounded value lies within 1e-4 of a
half-integer (the two sides divide and scale in float32 in another
order; those codes may then differ by exactly 1, and are counted), its
scales within rtol 1e-6."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as repro_config  # noqa: E402
from repro.configs import smoke_config as repro_smoke  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serve.lm import ServeLoop as JServeLoop  # noqa: E402
from repro.serve.lm import make_prefill_fn as j_prefill_fn  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import (decode_forward, forward,  # noqa: E402
                                            init_cache)
from repro_torch.serve.lm import ServeLoop, make_prefill_fn  # noqa: E402

NEW_ARCHS = ["gemma-2b", "qwen1.5-32b", "qwen2.5-32b", "granite-moe-3b-a800m",
             "mixtral-8x22b", "musicgen-large", "chameleon-34b"]
FRONTEND = {"musicgen-large": "FRONTEND_FRAMES",
            "chameleon-34b": "FRONTEND_PATCHES"}
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (small tensors;
    the suite's workers would oversubscribe the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Arch:
    """One arch's smoke config on both sides, its parameters and repro's
    jitted prefill and serving loop, shared by the module's tests."""

    def __init__(self, arch: str, kv_dtype: str = "bf16"):
        self.arch = arch
        self.jcfg = dataclasses.replace(repro_smoke(arch), kv_dtype=kv_dtype)
        self.cfg = dataclasses.replace(registry.smoke_config(arch),
                                       kv_dtype=kv_dtype)
        self.jparams = j_init(self.jcfg, jax.random.PRNGKey(3))
        tree = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.params = lm_params_from_numpy(tree, self.cfg, device="cpu")
        self.jprefill = jax.jit(j_prefill_fn(self.jcfg))
        self.jloop = JServeLoop(self.jcfg, self.jparams, max_len=32)


_ARCHS: dict = {}


def _arch(arch: str, kv_dtype: str = "bf16") -> Arch:
    key = (arch, kv_dtype)
    if key not in _ARCHS:
        _ARCHS[key] = Arch(arch, kv_dtype)
    return _ARCHS[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_archs():
    yield
    _ARCHS.clear()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_repro(arch):
    mod = registry._module(arch)
    for jcfg, cfg in ((repro_config(arch), registry.get_config(arch)),
                      (repro_smoke(arch), registry.smoke_config(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()
    if arch in FRONTEND:
        import importlib
        jmod = importlib.import_module(f"repro.configs.{mod.__name__.split('.')[-1]}")
        assert getattr(mod, FRONTEND[arch]) == getattr(jmod, FRONTEND[arch])


def test_registry_lists_the_attention_family():
    from repro.configs.registry import ARCHS as JARCHS

    assert registry.ARCHS == JARCHS
    assert registry.list_archs() == registry.ARCHS
    assert set(NEW_ARCHS) | {"gemma3-1b", "xlstm-125m", "zamba2-2.7b"} == \
        set(registry.ARCHS)


# ------------------------------------------------------------- prefill

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_matches_repro(arch):
    """B·S = 32, a multiple of the MoE smoke configs' routing group."""
    a = _arch(arch)
    toks = _tokens(a.cfg, 2, 16, seed=5)
    jh = j_forward(a.jparams, jnp.asarray(toks), a.jcfg, remat=False)
    jlg = a.jprefill(a.jparams, jnp.asarray(toks))
    ops.reset_counts()
    h = forward(a.params, torch.from_numpy(toks), a.cfg)
    lg = make_prefill_fn(a.cfg)(a.params, torch.from_numpy(toks))
    assert ops.PLAIN["flash_attention"] == 2 * a.cfg.n_layers
    assert h.dtype == torch.float32 and lg.shape == (2, a.cfg.vocab)
    _close(h, jh)
    _close(lg, jlg)


@pytest.mark.parametrize("arch", sorted(FRONTEND))
def test_frontend_prefill_matches_repro(arch):
    """A seeded 4-position prefix replaces the first token embeddings."""
    a = _arch(arch)
    toks = _tokens(a.cfg, 2, 16, seed=8)
    fe = np.random.default_rng(9).standard_normal(
        (2, 4, a.cfg.d_model)).astype(np.float32)
    assert a.params["frontend_proj"].shape == (a.cfg.d_model, a.cfg.d_model)
    jlg = a.jprefill(a.jparams, jnp.asarray(toks), jnp.asarray(fe))
    jh = j_forward(a.jparams, jnp.asarray(toks), a.jcfg,
                   frontend_embeds=jnp.asarray(fe), remat=False)
    prefill = make_prefill_fn(a.cfg)
    lg = prefill(a.params, torch.from_numpy(toks), torch.from_numpy(fe))
    h = forward(a.params, torch.from_numpy(toks), a.cfg,
                frontend_embeds=torch.from_numpy(fe))
    _close(h, jh)
    _close(lg, jlg)
    plain = prefill(a.params, torch.from_numpy(toks))
    assert float((lg - plain).abs().max()) > 1e-3     # the prefix shows


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_repro(arch):
    """Token by token, 20 steps: past mixtral's 16-slot rotating window."""
    a = _arch(arch)
    b, s = 2, 20
    toks = _tokens(a.cfg, b, s, seed=6)
    jcache = j_init_cache(a.jcfg, b, 24)
    cache = init_cache(a.cfg, b, 24, device="cpu")
    for pos in range(s):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = a.jloop._decode(a.jparams, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        lg, cache = decode_forward(a.params, cache, torch.from_numpy(tok),
                                   pos, a.cfg)
        assert lg.shape == (b, 1, a.cfg.vocab)
        _close(lg, jlg)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_loop_generates_repro_tokens(arch):
    a = _arch(arch)
    prompts = _tokens(a.cfg, 2, 8, seed=7)
    want = np.asarray(a.jloop.generate(jnp.asarray(prompts), n_new=16))
    got = ServeLoop(a.cfg, a.params, max_len=32).generate(
        torch.from_numpy(prompts), n_new=16)
    assert got.dtype == torch.int32 and got.shape == (2, 24)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ int8 cache

INT8_ARCHS = ["qwen2.5-32b", "granite-moe-3b-a800m"]


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_cache_matches_repro(arch, monkeypatch):
    """12 steps into a 16-slot cache (no slot rewritten).  The port's
    inserts are recorded to recover each code's unrounded value."""
    a = _arch(arch, "int8")
    b, s, n_layers = 2, 12, a.cfg.n_layers
    toks = _tokens(a.cfg, b, s, seed=10)
    jcache = j_init_cache(a.jcfg, b, 16)
    cache = init_cache(a.cfg, b, 16, device="cpu")
    assert cache[0]["k"]["q"].dtype == torch.int8
    assert cache[0]["k"]["s"].shape == (b, 16, a.cfg.n_kv_heads, 1)
    inserted = []
    insert = L._cache_insert
    monkeypatch.setattr(L, "_cache_insert", lambda c, new, slot: (
        inserted.append(new.clone()), insert(c, new, slot)))
    for pos in range(s):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = a.jloop._decode(a.jparams, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        lg, cache = decode_forward(a.params, cache, torch.from_numpy(tok),
                                   pos, a.cfg)
        _close(lg, jlg)
    assert len(inserted) == s * n_layers * 2
    jseg = jcache["seg0"]["pos0"]
    off_by_one = 0
    for layer in range(n_layers):
        for j, name in enumerate(("k", "v")):
            got_q = cache[layer][name]["q"][:, :s].numpy().astype(np.int32)
            want_q = np.asarray(jseg[name]["q"][layer])[:, :s].astype(np.int32)
            got_s = cache[layer][name]["s"][:, :s].numpy()
            want_s = np.asarray(jseg[name]["s"][layer])[:, :s]
            np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=0)
            new = torch.cat([inserted[p * 2 * n_layers + 2 * layer + j]
                             for p in range(s)], dim=1).float()
            scale = new.abs().amax(-1, keepdim=True).clamp(min=1e-9)
            raw = (new / scale * 127.0).numpy()
            diff = got_q != want_q
            assert (np.abs(got_q - want_q) <= 1).all()
            half = np.abs(np.abs(raw - np.floor(raw)) - 0.5)
            assert (half[diff] < 1e-4).all(), (
                f"layer {layer} {name}: codes part from repro's away from "
                f"a half-integer: {raw[diff]}")
            off_by_one += int(diff.sum())
    # counted, and few: a half-integer within 1e-4 is rare
    assert off_by_one <= 4, off_by_one


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_serve_loop_generates_repro_tokens(arch):
    a = _arch(arch, "int8")
    prompts = _tokens(a.cfg, 2, 8, seed=11)
    want = np.asarray(a.jloop.generate(jnp.asarray(prompts), n_new=16))
    got = ServeLoop(a.cfg, a.params, max_len=32).generate(
        torch.from_numpy(prompts), n_new=16)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ launchers

def test_shapes_are_repros():
    from repro.launch import shapes as jshapes

    from repro_torch.launch import shapes

    assert {n: dataclasses.astuple(s) for n, s in shapes.SHAPES.items()} == \
        {n: dataclasses.astuple(s) for n, s in jshapes.SHAPES.items()}
    assert shapes.LONG_OK == jshapes.LONG_OK
    assert shapes.FRONTEND_LEN == jshapes.FRONTEND_LEN
    assert shapes.FRONTEND_LEN == {a: getattr(registry._module(a), n)
                                   for a, n in FRONTEND.items()}
    cells = shapes.all_cells()
    assert len(cells) == len(registry.ARCHS) * len(shapes.SHAPES)
    for arch, shape in cells:
        assert shapes.cell_enabled(arch, shape) == jshapes.cell_enabled(arch, shape)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "chameleon-34b"])
def test_serve_launcher_generates(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--new-tokens", "4"])
    assert out.shape == (2, 12) and out.dtype == torch.int32
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith(f"{registry.smoke_config(arch).name}: "
                                 f"generated 2x4 tokens in ")
    assert printed[1] == f"sample: {out[0].tolist()}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch])
