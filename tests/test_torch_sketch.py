"""The plain versions of this slice's kernels against ``repro``, on the CPU.

* ``doc_sketch`` against ``repro.core.meanindex.doc_sketch``;
* ``sketch_sim`` against ``repro``'s Pallas kernel in interpret mode
  (``repro.kernels.ops.sketch_sim``), at widths that are multiples of
  nothing, K = 1 and an odd row count;
* the gather kernel's per-row-threshold variant (``esicp_gather(v_ta=)``)
  against ``repro``'s TAAT scan ``reference_scan(mode="ta")``, with rows
  whose ρ_self <= 0 make v_ta = 0;
* the CS accumulators (three sparse_sim launches, one squared) against
  ``reference_scan(mode="cs")`` at t_th = 0, where ``repro`` counts the dead
  slots (id 0) in the tail sum of squares, and at t_th > 0;
* the Region-3 sketch bound and its pair counts against ``repro``'s
  ``_region3_bound``.

Floats within 1e-5 (float32 sums in another order: XLA's CPU dot does not
add in s order), Mult and pair counts exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import assignment as ja, meanindex as jmi  # noqa: E402
from repro.core.backends import reference_scan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.sparse import SparseDocs as JDocs  # noqa: E402

from repro_torch.core import assignment as ta, meanindex as tmi  # noqa: E402
from repro_torch.core.backends import KernelBackend  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.sparse.matrix import SparseDocs  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _corpus(b, p, d, k, seed):
    """Padded rows with an empty row, dead slots (id 0, value 0) and ids up
    to the last term; (K, D) unit means with most entries absent."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, p + 1, b)
    nnz[0] = 0
    nnz[1] = p
    ids = np.zeros((b, p), np.int32)
    vals = np.zeros((b, p), np.float32)
    for i in range(b):
        ids[i, :nnz[i]] = np.sort(rng.choice(d, nnz[i], replace=False))
        vals[i, :nnz[i]] = rng.random(nnz[i]) + 0.05
    ids[1, -1] = d - 1                              # the clip boundary
    vals /= np.maximum(np.linalg.norm(vals, axis=1, keepdims=True), 1e-12)
    means = rng.random((k, d)).astype(np.float32)
    means[rng.random((k, d)) < 0.6] = 0.0
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    return ids, vals, nnz.astype(np.int32), means


def _both(ids, vals, nnz, means, t_th, v_th, moving=None):
    d = means.shape[1]
    moving = np.ones(means.shape[0], bool) if moving is None else moving
    jdocs = JDocs(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                  nnz=jnp.asarray(nnz), dim=d)
    jidx = jmi.build_mean_index(
        jnp.asarray(means), jmi.StructuralParams(jnp.int32(t_th),
                                                 jnp.float32(v_th)),
        moving=jnp.asarray(moving))
    tdocs = SparseDocs(_t(ids), _t(vals), _t(nnz), d)
    tidx = tmi.build_mean_index(_t(means.T.copy()),
                                tmi.StructuralParams(t_th, v_th),
                                moving=_t(moving))
    return jdocs, jidx, tdocs, tidx


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [64, 300, 1000, 4097])
def test_doc_sketch_plain_matches_repro(d):
    ids, vals, _, _ = _corpus(33, 21, d, 2, seed=d)
    want = np.asarray(jmi.doc_sketch(jnp.asarray(ids), jnp.asarray(vals), d))
    got = tmi.doc_sketch(_t(ids), _t(vals), d)
    assert got.shape == want.shape == (33, tmi.sketch_size(d))
    _close(got, want)
    assert (got.numpy()[0] == 0).all()               # the empty row


@pytest.mark.parametrize("b,s,k", [(37, 61, 1), (129, 23, 300), (5, 64, 7)])
def test_sketch_sim_plain_matches_repro_interpret(b, s, k):
    rng = np.random.default_rng(b + s + k)
    x = rng.random((b, s)).astype(np.float32)
    x[rng.random((b, s)) < 0.5] = 0.0
    m = rng.random((s, k)).astype(np.float32)
    got = ref.sketch_sim(_t(x), _t(m))
    _close(got, jops.sketch_sim(jnp.asarray(x), jnp.asarray(m),
                                interpret=True))
    # each output is the s-ordered sum of rounded products
    want = np.zeros((b, k), np.float32)
    for q in range(s):
        want = (want + (x[:, q:q + 1] * m[q]).astype(np.float32)
                ).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # binarised operands give exact integer counts
    pairs = ref.sketch_sim(_t((x > 0).astype(np.float32)),
                           _t((m > 0.5).astype(np.float32)))
    np.testing.assert_array_equal(
        pairs.numpy(), (x > 0).astype(np.int64) @ (m > 0.5).astype(np.int64))


@pytest.mark.parametrize("t_th,v_th", [(0, 1.0), (180, 0.08)])
def test_ta_gather_plain_matches_reference_scan(t_th, v_th):
    ids, vals, nnz, means = _corpus(40, 17, 300, 23, seed=3)
    rng = np.random.default_rng(4)
    rho_self = rng.random(40).astype(np.float32) * 0.6
    rho_self[::5] = -np.inf                         # iteration 1: no history
    rho_self[1::7] = 0.0                            # ρ_self <= 0: v_ta = 0
    l1 = vals.sum(axis=1)
    v_ta = (np.maximum(rho_self, 0) / np.maximum(l1, 1e-12)).astype(
        np.float32)
    assert (v_ta == 0).sum() >= 10
    xstate = rng.random(40) < 0.5
    moving = rng.random(23) < 0.5
    jdocs, jidx, tdocs, tidx = _both(ids, vals, nnz, means, t_th, v_th,
                                     moving)
    want = reference_scan(jdocs, jidx, jnp.asarray(xstate), mode="ta",
                          v_ta=jnp.asarray(v_ta))
    rho12, y, sims, counts = ops.esicp_gather(
        tdocs.ids, tdocs.vals, tidx.means_t, t_th, v_th, with_counts=True,
        v_ta=_t(v_ta))
    for got, key in ((rho12, "rho12"), (y, "y"), (sims, "sims")):
        _close(got, want[key])
    out = KernelBackend().accumulate(tdocs, tidx, _t(xstate), mode="ta",
                                     v_ta=_t(v_ta))
    assert int(out["mult"]) == int(want["mult"])
    assert torch.equal(out["rho12"], rho12) and torch.equal(out["y"], y)
    # v_ta = 0 makes every visited entry exact: no Region-3 mass, and the
    # rows count what the plain scan visits
    zero = _t(v_ta == 0)
    assert (y.numpy()[v_ta == 0] == 0).all()
    _, all_counts = ops.sparse_sim(tdocs.ids, tdocs.vals, tidx.means_t,
                                   with_counts=True)
    assert torch.equal(counts[zero], all_counts[zero])


@pytest.mark.parametrize("t_th", [0, 150])
def test_cs_accumulators_match_reference_scan(t_th):
    ids, vals, nnz, means = _corpus(30, 19, 300, 17, seed=5)
    rng = np.random.default_rng(6)
    xstate = rng.random(30) < 0.5
    moving = rng.random(17) < 0.5
    jdocs, jidx, tdocs, tidx = _both(ids, vals, nnz, means, t_th, 0.1,
                                     moving)
    want = reference_scan(jdocs, jidx, jnp.asarray(xstate), mode="cs")
    got = KernelBackend().accumulate(tdocs, tidx, _t(xstate), mode="cs")
    for key in ("rho1", "sq", "sims"):
        _close(got[key], want[key])
    assert int(got["mult"]) == int(want["mult"])
    # the squared launch is sparse_sim over the squared matrix, bit for bit
    ones = (tdocs.ids >= t_th).to(torch.float32)
    sq2, _ = ref.sparse_sim(tdocs.ids, ones, tidx.means_t * tidx.means_t)
    assert torch.equal(got["sq"], sq2)
    dead = (tdocs.ids == 0) & (tdocs.vals == 0)
    if t_th == 0:                    # dead slots count m[0]² (repro's quirk)
        extra = dead.sum(1, keepdim=True) * tidx.means_t[0] ** 2
        assert bool((extra > 0).any())
        live_only, _ = ref.sparse_sim(
            tdocs.ids, ones.masked_fill(dead, 0.0), tidx.means_t,
            square=True)
        _close(got["sq"] - live_only, extra)


@pytest.mark.parametrize("t_th,v_th", [(0, 1.0), (200, 0.1), (299, 0.05)])
def test_region3_bound_matches_repro(t_th, v_th):
    ids, vals, nnz, means = _corpus(31, 23, 300, 19, seed=t_th)
    jdocs, jidx, tdocs, tidx = _both(ids, vals, nnz, means, t_th, v_th)
    w_bound, w_pairs = ja._region3_bound(jdocs, jidx)
    g_bound, g_pairs = ta._region3_bound(tdocs, tidx)
    _close(g_bound, w_bound)
    np.testing.assert_array_equal(g_pairs.numpy(), np.asarray(w_pairs))
    np.testing.assert_array_equal(
        ta._sketch_pairs(tdocs, tidx).numpy(),
        np.asarray(ja._sketch_pairs(jdocs, jidx)))
    # the Region-3 sketch reads only rows >= t_th
    r3 = tmi.region3_sketch(tidx)
    g = tmi.sketch_group_width(300)
    assert (r3.numpy()[:t_th // g] == 0).all()
