"""The port's SSM layer kinds (``repro_torch.models.ssm``: mamba2, mLSTM,
sLSTM; zamba2's shared attention block) and the two archs built on them,
xlstm-125m and zamba2-2.7b, against ``repro`` on the CPU, float32 on both
sides.

Inputs come from a numpy seed; parameters from ``repro.models.init_params``
(the vectors ``repro`` starts at constants — ``b_gates``, ``log_A``, ``D``,
``dt_bias`` — redrawn from the seed where a single block is held, so they
take part), carried across with ``convert.lm_params_from_numpy``.
Tolerances: 1e-5 for the chunked recurrence, each block and each decode
step (float32 sums in another order), 1e-4 for prefill logits through a
few layers, 1e-5 for the decode caches after a prompt, 2e-3 for the port's
own decode against its forward (``tests/test_models.py``'s bar); greedy
tokens identical.  The sLSTM scan's plain version carried across two
calls equals one call bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as repro_config  # noqa: E402
from repro.configs import smoke_config as repro_smoke  # noqa: E402
from repro.models import decode_forward as j_decode  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.lm import ServeLoop as JServeLoop  # noqa: E402
from repro.serve.lm import make_prefill_fn as j_prefill_fn  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import (lm_cache_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.transformer import (decode_forward, forward,  # noqa: E402
                                            init_cache, init_params, logits,
                                            tree_to)
from repro_torch.serve.lm import ServeLoop, make_prefill_fn  # noqa: E402

SSM_ARCHS = ["xlstm-125m", "zamba2-2.7b"]
F32 = torch.float32


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
    jitted prefill, decode step and serving loop, shared by the module's
    tests."""

    def __init__(self, arch: str):
        self.jcfg = repro_smoke(arch)
        self.cfg = registry.smoke_config(arch)
        self.jparams = j_init(self.jcfg, jax.random.PRNGKey(3))
        tree = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.params = lm_params_from_numpy(tree, self.cfg, device="cpu")
        self.jprefill = jax.jit(j_prefill_fn(self.jcfg))
        self.jstep = jax.jit(lambda p, c, t, i: j_decode(p, c, t, i,
                                                         self.jcfg))
        self.jloop = JServeLoop(self.jcfg, self.jparams, max_len=32)


_ARCHS: dict = {}


def _arch(arch: str) -> Arch:
    if arch not in _ARCHS:
        _ARCHS[arch] = Arch(arch)
    return _ARCHS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_archs():
    yield
    _ARCHS.clear()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _layer(arch: str, pos: int, seed: int, gate_scale: float = 1.0):
    """(repro config, port config, numpy leaves, torch leaves) of smoke
    segment position ``pos``'s first layer, the constant-initialised
    vectors redrawn from ``seed``; ``w_gates`` scaled by ``gate_scale``."""
    jcfg = repro_smoke(arch)
    cfg = registry.smoke_config(arch)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                j_init(jcfg, jax.random.PRNGKey(seed))["seg0"][f"pos{pos}"])
    rng = np.random.default_rng(seed)
    for name in ("b_gates", "log_A", "D", "dt_bias", "ln1"):
        if name in jp:
            jp[name] = (rng.standard_normal(jp[name].shape) * 0.5).astype(np.float32)
    if "w_gates" in jp:
        jp["w_gates"] = jp["w_gates"] * np.float32(gate_scale)
    return jcfg, cfg, jp, {n: _t(a) for n, a in jp.items()}


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


# ------------------------------------------------- (a) chunked recurrence

@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 32, 3, 5, 4, 16),
                                             (1, 48, 2, 8, 6, 8)])
@pytest.mark.parametrize("decay_scale", [0.3, 20.0])
def test_chunked_glr_matches_repro(b, s, h, p, n, chunk, decay_scale):
    """decay_scale 20: log decays of about -20 a step, so most decays
    within a chunk pass the -60 clip."""
    rng = np.random.default_rng(s * h + int(decay_scale))
    xv = rng.standard_normal((b, s, h, p)).astype(np.float32)
    kb = rng.standard_normal((b, s, h, n)).astype(np.float32)
    qc = rng.standard_normal((b, s, h, n)).astype(np.float32)
    log_a = (-rng.random((b, s, h)) * decay_scale).astype(np.float32)
    want = JS._chunked_glr(xv, kb, qc, log_a, chunk)
    got = S._chunked_glr(_t(xv), _t(kb), _t(qc), _t(log_a), chunk, F32)
    assert got.dtype == F32 and got.shape == (b, s, h, p)
    _close(got, want, 1e-5)


def test_chunked_glr_raises_on_a_partial_chunk():
    z = torch.zeros((1, 20, 2, 3))
    with pytest.raises(ValueError, match="S 20 is not a multiple of the "
                                         "chunk 16"):
        S._chunked_glr(z, z, z, torch.zeros((1, 20, 2)), 16, F32)


def test_softplus_has_no_threshold():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 21.0, 60.0], np.float32)
    _close(S.softplus(_t(x)), jax.nn.softplus(x), 1e-6)


# ------------------------------------------------------------- (b) blocks

@pytest.mark.parametrize("arch,pos,kind", [("zamba2-2.7b", 0, "mamba2"),
                                           ("xlstm-125m", 0, "mlstm"),
                                           ("xlstm-125m", 1, "slstm")])
@pytest.mark.parametrize("gate_scale", [1.0, 10.0])
def test_block_matches_repro(arch, pos, kind, gate_scale):
    """gate_scale 10 (the sLSTM's w_gates; the others unchanged) puts
    gates of |i|, |f| up to about 30 through the stabiliser."""
    jcfg, cfg, jp, p = _layer(arch, pos, seed=11, gate_scale=gate_scale)
    x = _x(cfg, 2, 32, seed=12)
    jfn = {"mamba2": JS.mamba2_block, "mlstm": JS.mlstm_block,
           "slstm": JS.slstm_block}[kind]
    fn = {"mamba2": S.mamba2_block, "mlstm": S.mlstm_block,
          "slstm": S.slstm_block}[kind]
    ops.reset_counts()
    got = fn(torch.from_numpy(x), p, cfg, F32)
    assert ops.PLAIN["slstm_scan"] == (kind == "slstm")
    _close(got, jfn(x, jp, jcfg), 1e-5)


def _state(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_decode_step_matches_repro(kind):
    """One step from a non-zero state: output and new state within 1e-5."""
    arch, pos = {"mamba2": ("zamba2-2.7b", 0), "mlstm": ("xlstm-125m", 0),
                 "slstm": ("xlstm-125m", 1)}[kind]
    jcfg, cfg, jp, p = _layer(arch, pos, seed=13)
    x = _x(cfg, 3, 1, seed=14)
    rng = np.random.default_rng(15)
    d, h = cfg.d_model, cfg.n_heads
    if kind == "mamba2":
        st = _state(rng, 3, h, cfg.ssm_state, cfg.ssm_expand * d // h)
        jy, jst = JS.mamba2_decode(x, jp, jcfg, st)
        y, got = S.mamba2_decode(torch.from_numpy(x), p, cfg, _t(st), F32)
        pairs = [(got, jst)]
    elif kind == "mlstm":
        C, n = _state(rng, 3, h, d // h, d // h), _state(rng, 3, h, d // h)
        jy, jC, jn = JT._mlstm_decode(x, jp, jcfg, C, n)
        y, gC, gn = S.mlstm_decode(torch.from_numpy(x), p, cfg, _t(C), _t(n),
                                   F32)
        pairs = [(gC, jC), (gn, jn)]
    else:
        c = {"c": _state(rng, 3, d), "n": np.abs(_state(rng, 3, d)) + 0.5,
             "m": _state(rng, 3, d, scale=3.0)}
        jy, jnew = JT._slstm_decode(x, jp, jcfg, c)
        y, new = S.slstm_decode(torch.from_numpy(x), p, cfg,
                                {k: _t(v) for k, v in c.items()}, F32)
        pairs = [(new[k], jnew[k]) for k in ("c", "n", "m")]
    assert y.shape == (3, 1, d)
    _close(y, jy, 1e-5)
    for got, want in pairs:
        _close(got, want, 1e-5)


# ------------------------------------------------------ (c) sLSTM scan

@pytest.mark.parametrize("b,s,d", [(2, 40, 5), (3, 17, 33)])
def test_slstm_scan_split_equals_whole(b, s, d):
    """S steps in one call equal S/2 + S/2 with the state carried, bit for
    bit (the decode path carries it one step at a time)."""
    gen = torch.Generator().manual_seed(b * s + d)
    gates = torch.randn((b, s, 4 * d), generator=gen) * 10
    zero = torch.zeros((b, d))
    m0 = torch.full((b, d), -1e30)
    hs, c, n, m = ref.slstm_scan(gates, zero, zero, m0)
    half = s // 2
    hs1, c1, n1, m1 = ref.slstm_scan(gates[:, :half].contiguous(), zero, zero, m0)
    hs2, c2, n2, m2 = ref.slstm_scan(gates[:, half:].contiguous(), c1, n1, m1)
    assert torch.equal(torch.cat([hs1, hs2], dim=1), hs)
    for a, w in ((c2, c), (n2, n), (m2, m)):
        assert torch.equal(a, w)
    assert bool(torch.isfinite(hs).all())


def test_slstm_scan_validates_operands():
    z = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="4·D"):
        ops.slstm_scan(torch.zeros((2, 5, 10)), z, z, z)
    with pytest.raises(ValueError, match="c0 must be"):
        ops.slstm_scan(torch.zeros((2, 5, 12)), torch.zeros((2, 4)), z, z)
    with pytest.raises(TypeError, match="gates must be"):
        ops.slstm_scan(torch.zeros((2, 5, 12), dtype=torch.float64), z, z, z)
    ops.reset_counts()
    hs, c, n, m = ops.slstm_scan(torch.zeros((2, 0, 12)), z, z, z - 1e30)
    assert hs.shape == (2, 0, 3) and torch.equal(m, z - 1e30)
    assert ops.PLAIN["slstm_scan"] == 1 and ops.LAUNCHES["slstm_scan"] == 0


# --------------------------------------------- (d) whole archs, prefill

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_matches_repro(arch):
    a = _arch(arch)
    toks = _tokens(a.cfg, 2, 32, seed=5)
    jh = JT.forward(a.jparams, jnp.asarray(toks), a.jcfg, remat=False)
    want = a.jprefill(a.jparams, jnp.asarray(toks))
    ops.reset_counts()
    h = forward(a.params, torch.from_numpy(toks), a.cfg)
    kinds = [sp.kind for seg in a.cfg.segments for _ in range(seg.reps)
             for sp in seg.layers]
    assert ops.PLAIN["slstm_scan"] == kinds.count("slstm")
    assert ops.PLAIN["flash_attention"] == kinds.count("shared_attn")
    got = make_prefill_fn(a.cfg)(a.params, torch.from_numpy(toks))
    assert h.dtype == F32 and got.shape == (2, a.cfg.vocab)
    _close(h, jh, 1e-4)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_refuses_a_partial_chunk(arch):
    a = _arch(arch)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        forward(a.params, torch.zeros((1, 20), dtype=torch.int32), a.cfg)


# ---------------------------------------------- (e) decode and serving

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_loop_generates_repro_tokens(arch):
    a = _arch(arch)
    prompts = _tokens(a.cfg, 2, 8, seed=7)
    want = np.asarray(a.jloop.generate(jnp.asarray(prompts), n_new=16))
    got = ServeLoop(a.cfg, a.params, max_len=32).generate(
        torch.from_numpy(prompts), n_new=16)
    assert got.dtype == torch.int32 and got.shape == (2, 24)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_caches_match_repro(arch):
    """The decode caches after an 8-token prompt, layer by layer: every
    leaf of repro's (SSM states, the shared block's per-invocation K/V)
    within 1e-5; each step's logits within 1e-4."""
    a = _arch(arch)
    toks = _tokens(a.cfg, 2, 8, seed=8)
    jcache = j_init_cache(a.jcfg, 2, 16)
    cache = init_cache(a.cfg, 2, 16, device="cpu")
    for pos in range(8):
        tok = toks[:, pos:pos + 1]
        jlg, jcache = a.jstep(a.jparams, jcache, jnp.asarray(tok),
                              jnp.asarray(pos))
        lg, cache = decode_forward(a.params, cache, torch.from_numpy(tok),
                                   pos, a.cfg)
        _close(lg, jlg, 1e-4)
    want = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                               a.cfg, device="cpu")
    assert len(want) == len(cache) == a.cfg.n_layers
    for got_l, want_l in zip(cache, want):
        assert set(got_l) == set(want_l)
        for name in got_l:
            assert got_l[name].dtype == want_l[name].dtype
            _close(got_l[name], want_l[name], 1e-5)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_own_forward(arch):
    """Decode token by token == the teacher-forced forward, at
    ``tests/test_models.py``'s 2e-3."""
    a = _arch(arch)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(a.cfg, b, s, seed=9))
    full = logits(a.params, forward(a.params, toks, a.cfg), a.cfg)
    cache = init_cache(a.cfg, b, s, device="cpu")
    for pos in range(s):
        lg, cache = decode_forward(a.params, cache, toks[:, pos:pos + 1], pos,
                                   a.cfg)
        _close(lg[:, 0], full[:, pos, :a.cfg.vocab], 2e-3)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_cache_kinds(arch):
    cfg = registry.smoke_config(arch)
    cache = init_cache(cfg, 3, 20, device="cpu")
    d, h = cfg.d_model, cfg.n_heads
    for spec, c in zip((sp for seg in cfg.segments for _ in range(seg.reps)
                        for sp in seg.layers), cache):
        if spec.kind == "mamba2":
            assert c["state"].shape == (3, h, cfg.ssm_state,
                                        cfg.ssm_expand * d // h)
        elif spec.kind == "mlstm":
            assert c["C"].shape == (3, h, d // h, d // h)
            assert c["n"].shape == (3, h, d // h)
        elif spec.kind == "slstm":
            assert set(c) == {"c", "n", "m"}
            assert bool((c["m"] == -1e30).all()) and not c["c"].any()
        else:
            assert spec.kind == "shared_attn"
            assert c["k"].shape == (3, 20, cfg.n_kv_heads, cfg.hd)
        assert all(t.dtype == F32 for t in c.values())
    # each shared_attn invocation has a cache of its own
    kv = [c["k"] for c in cache if "k" in c]
    assert len({id(t) for t in kv}) == len(kv)


# ------------------------------------------------ (f) parameters, configs

def test_shared_block_is_one_dict():
    """zamba2: every shared_attn layer is the ``shared`` dict, converted
    from repro, drawn by init_params and moved to a device alike; the
    parameter count counts it once."""
    a = _arch("zamba2-2.7b")
    shared = [lp for lp, sp in zip(a.params["layers"],
                                   (sp for seg in a.cfg.segments
                                    for _ in range(seg.reps)
                                    for sp in seg.layers))
              if sp.kind == "shared_attn"]
    assert len(shared) == 2 and all(lp is a.params["shared"] for lp in shared)
    params = init_params(a.cfg, torch.Generator().manual_seed(0), device="cpu")
    moved = tree_to(params, "cpu")
    for tree in (params, moved):
        assert sum(lp is tree["shared"] for lp in tree["layers"]) == 2
    seen = {id(t): t.numel() for t in _tensors(params)}
    assert sum(seen.values()) == a.cfg.n_params() == a.jcfg.n_params()
    assert not params["layers"][0]["log_A"].any()
    assert bool((params["layers"][0]["D"] == 1).all())
    assert bool((params["layers"][0]["dt_bias"] == -2).all())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        for v in tree:
            yield from _tensors(v)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_config_matches_repro(arch):
    for jcfg, cfg in ((repro_config(arch), registry.get_config(arch)),
                      (repro_smoke(arch), registry.smoke_config(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()


def test_full_widths():
    """zamba2-2.7b: 54 layers, 9 shared_attn invocations of one block, hd
    80; xlstm-125m: 12 layers, 2 of them sLSTM."""
    z = registry.get_config("zamba2-2.7b")
    kinds = [sp.kind for seg in z.segments for _ in range(seg.reps)
             for sp in seg.layers]
    assert z.n_layers == 54 and kinds.count("shared_attn") == 9 and z.hd == 80
    x = registry.get_config("xlstm-125m")
    kinds = [sp.kind for seg in x.segments for _ in range(seg.reps)
             for sp in seg.layers]
    assert x.n_layers == 12 and kinds.count("slstm") == 2


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_launcher_generates(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--new-tokens", "4"])
    assert out.shape == (2, 12) and out.dtype == torch.int32
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith(f"{registry.smoke_config(arch).name}: "
                                 f"generated 2x4 tokens in ")
