"""The port's ``moe_mlp`` (``repro_torch.models.layers``) against
``repro.models.layers.moe_mlp`` on the CPU, float32 on both sides.

Inputs and weights come from a numpy seed.  The expert picks are held
first: where the port's top-k parts from ``jax.lax.top_k``'s, the two
router logits at the boundary must lie within 1e-6 of each other (a near
tie), else the test fails; the outputs are then compared within 1e-5 on
every routing group whose picks agree (float32 sums of the same k terms
in another order).  Exact ties (a router with equal columns) must give the
lower expert ids, as ``jax.lax.top_k`` does."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as repro_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

F32 = torch.float32
MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x22b"]
NEAR_TIE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (small tensors;
    the suite's workers would oversubscribe the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(cfg, seed, ties=None):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    norm = lambda shp, fan_in: (rng.standard_normal(shp)
                                / np.sqrt(fan_in)).astype(np.float32)
    router = norm((d, e), d)
    if ties == "all":            # every expert's logit equal
        router[:] = router[:, :1]
    elif ties == "pairs":        # experts 2j and 2j + 1 tied
        router[:, 1::2] = router[:, 0::2]
    return {
        "router": router,
        "w_gate": norm((e, d, f), d),
        "w_up": norm((e, d, f), d),
        "w_down": norm((e, f, d), f),
    }


def _picks(cfg, x, router):
    """(repro's picks, the port's picks, the port's sorted logits), each
    over (groups, g, ·)."""
    b, s, d = x.shape
    g = min(cfg.moe_group, b * s)
    xf = x.reshape(-1, g, d)
    jl = jnp.asarray(xf) @ jnp.asarray(router)
    _, jidx = jax.lax.top_k(jl, cfg.top_k)
    tl = torch.from_numpy(xf) @ torch.from_numpy(router)
    _, tidx = L.top_k_lower_first(tl, cfg.top_k)
    return np.asarray(jidx), tidx.numpy(), torch.sort(tl, -1, True)[0].numpy()


def _hold(cfg, jcfg, x, p):
    """Returns the groups whose picks part from repro's (each at a near
    tie) after comparing the outputs on the others within 1e-5."""
    jidx, tidx, sorted_l = _picks(cfg, x, p["router"])
    k = cfg.top_k
    parted = (np.sort(jidx, -1) != np.sort(tidx, -1)).any(-1)   # (ng, g)
    for n, t in zip(*np.nonzero(parted)):
        gap = sorted_l[n, t, k - 1] - sorted_l[n, t, k]
        assert gap < NEAR_TIE, (
            f"group {n} token {t}: picks {tidx[n, t]} vs repro's "
            f"{jidx[n, t]} with a logit gap {gap} (not a near tie)")
    want = np.asarray(JL.moe_mlp(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), jcfg))
    got = L.moe_mlp(torch.from_numpy(x),
                    {n: torch.from_numpy(a) for n, a in p.items()}, cfg, F32)
    assert got.dtype == F32 and got.shape == x.shape
    b, s, d = x.shape
    g = min(cfg.moe_group, b * s)
    agree = ~parted.any(-1)
    np.testing.assert_allclose(got.numpy().reshape(-1, g, d)[agree],
                               want.reshape(-1, g, d)[agree],
                               rtol=1e-5, atol=1e-5)
    return int((~agree).sum()), tidx


def _dropped(cfg, tidx) -> int:
    """Picks past an expert's capacity, counted from the port's picks."""
    ng, g, _ = tidx.shape
    cap = L.moe_capacity(cfg, g)
    counts = np.stack([np.bincount(tidx[n].ravel(), minlength=cfg.n_experts)
                       for n in range(ng)])
    return int(np.clip(counts - cap, 0, None).sum())


CASES = {
    # (batch, seq, config changes, ties)
    "smoke": (2, 32, {}, None),
    "drop": (2, 32, {"moe_capacity": 0.5}, None),
    "decode": (4, 1, {}, None),
    "ties_all": (2, 16, {}, "all"),
    "ties_pairs": (2, 16, {"top_k": 3}, "pairs"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_repro(arch, case):
    b, s, change, ties = CASES[case]
    jcfg = dataclasses.replace(repro_smoke(arch), **change)
    cfg = dataclasses.replace(registry.smoke_config(arch), **change)
    p = _weights(cfg, seed=len(case) + cfg.d_model, ties=ties)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    parted, tidx = _hold(cfg, jcfg, x, p)
    if ties is not None:
        assert parted == 0
    if ties == "all":
        # every logit equal: the k lowest expert ids, in order
        assert (tidx == np.arange(cfg.top_k)).all()
    if ties == "pairs":
        # the third pick comes from a tied pair: the lower id of it
        assert (tidx % 2 == 0)[..., [0, 2]].all()
    if case == "drop":
        assert _dropped(cfg, tidx) > 0
    else:
        assert _dropped(cfg, tidx) == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_is_repros(arch):
    jcfg = repro_smoke(arch)
    cfg = registry.smoke_config(arch)
    for g in (1, 2, 3, 4, 7, 32, 256):
        for cap in (0.5, 1.0, 1.25, 8.0):
            want = int(g * jcfg.top_k / jcfg.n_experts * cap) + 1
            want = min(want + (-want) % 4, g)
            assert L.moe_capacity(dataclasses.replace(cfg, moe_capacity=cap),
                                  g) == want


def test_top_k_lower_first_is_lax_top_k():
    x = np.array([1, 3, 3, 2, 3, 0, 3, 3], np.float32)
    vals, idx = L.top_k_lower_first(torch.from_numpy(x), 3)
    assert idx.tolist() == [1, 2, 4] and vals.tolist() == [3, 3, 3]
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (50, 40)).astype(np.float32)     # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    tv, ti = L.top_k_lower_first(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_mlp_refuses_an_indivisible_token_count():
    cfg = registry.smoke_config("granite-moe-3b-a800m")
    p = {n: torch.from_numpy(a) for n, a in _weights(cfg, 0).items()}
    x = torch.zeros((1, 33, cfg.d_model))
    with pytest.raises(ValueError, match="routing groups"):
        L.moe_mlp(x, p, cfg, F32)
    # a decode-sized call is one group of B tokens
    assert L.moe_mlp(torch.zeros((3, 1, cfg.d_model)), p, cfg,
                     F32).shape == (3, 1, cfg.d_model)
