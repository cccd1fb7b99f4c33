"""The port's core against ``repro.core`` on the same numpy inputs: the
mean index, normalisation with an empty cluster, moving flags, drift
bounds, the update step and EstParams.  Both run on the CPU; means are
compared to 1e-6 (float32 norms taken in another order), integers and the
chosen thresholds exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import meanindex as jmi, update as jup  # noqa: E402
from repro.core.estparams import EstGrid as JGrid  # noqa: E402
from repro.core.estparams import estimate_params as jestimate  # noqa: E402
from repro.core.lloyd import lloyd_fit as jfit  # noqa: E402
from repro_torch.convert import docs_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core import meanindex as tmi, update as tup  # noqa: E402
from repro_torch.core.backends import KernelBackend  # noqa: E402
from repro_torch.core.estparams import EstGrid, estimate_params  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit_means(rng, d, k, sparsity=0.7):
    m = rng.random((k, d)).astype(np.float32)
    m[rng.random((k, d)) < sparsity] = 0
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


@pytest.mark.parametrize("t_th,v_th", [(0, 1.0), (150, 0.05), (299, 0.2)])
def test_build_mean_index_matches_repro(t_th, v_th):
    rng = np.random.default_rng(0)
    means = _unit_means(rng, 300, 24)
    moving = rng.random(24) < 0.5
    jp = jmi.StructuralParams(jnp.int32(t_th), jnp.float32(v_th))
    ji = jmi.build_mean_index(jnp.asarray(means), jp,
                              moving=jnp.asarray(moving))
    ti = tmi.build_mean_index(_t(means.T.copy()),
                              tmi.StructuralParams(t_th, v_th),
                              moving=_t(moving))
    np.testing.assert_array_equal(np.asarray(ji.means_t), ti.means_t.numpy())
    np.testing.assert_array_equal(np.asarray(ji.mf), ti.mf.numpy())
    np.testing.assert_array_equal(np.asarray(ji.mf_h), ti.mf_h.numpy())
    assert int(ji.n_moving) == int(ti.n_moving)
    np.testing.assert_allclose(np.asarray(ji.sketch_t), ti.sketch_t.numpy(),
                               rtol=1e-6, atol=1e-6)
    # with_params recomputes only what depends on the thresholds
    tj = ti.with_params(tmi.StructuralParams(10, 0.1))
    jj = ji.with_params(jmi.StructuralParams(jnp.int32(10), jnp.float32(0.1)))
    np.testing.assert_array_equal(np.asarray(jj.mf_h), tj.mf_h.numpy())


def test_normalized_means_keeps_empty_cluster():
    rng = np.random.default_rng(1)
    lam = rng.random((6, 40)).astype(np.float32)
    lam[2] = 0.0                                       # an empty cluster
    prev = _unit_means(rng, 40, 6).T.copy()            # (D, K)
    want = np.asarray(jmi.normalized_means(jnp.asarray(lam),
                                           jnp.asarray(prev)))
    lam_t = _t(lam.T.copy())
    got = tmi.normalized_means(lam_t, _t(prev))
    assert got.data_ptr() == lam_t.data_ptr()          # normalised in place
    np.testing.assert_allclose(got.numpy().T, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[:, 2], prev[:, 2])


def test_moving_flags_match_repro():
    rng = np.random.default_rng(2)
    prev = rng.integers(0, 9, 200).astype(np.int32)
    cur = prev.copy()
    flip = rng.random(200) < 0.05
    cur[flip] = rng.integers(0, 9, flip.sum())
    want = np.asarray(jup.moving_flags(jnp.asarray(cur), jnp.asarray(prev), 11))
    got = tup.moving_flags(_t(cur), _t(prev), 11)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("k", [5, 16, 37])
def test_group_drift_and_loosen_match_repro(k):
    rng = np.random.default_rng(k)
    old = _unit_means(rng, 60, k).T.copy()
    new = _unit_means(rng, 60, k).T.copy()
    new[:, 0] = old[:, 0]                              # a centroid that stayed
    want = np.asarray(jup.group_drift(jnp.asarray(new), jnp.asarray(old)))
    got = tup.group_drift(_t(new), _t(old))
    assert got.shape == (tup.n_ub_groups(k),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ub = rng.random((30, tup.n_ub_groups(k))).astype(np.float32)
    ub[0, 0] = np.inf
    np.testing.assert_allclose(
        tup.drift_loosen(_t(ub), _t(want)).numpy(),
        np.asarray(jup.drift_loosen(jnp.asarray(ub), jnp.asarray(want))),
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def warm(small_corpus):
    """repro's state after two ES-ICP iterations on the shared corpus."""
    docs, df, _, _ = small_corpus
    res = jfit(docs, k=16, algo="esicp", backend="reference", max_iter=2,
               batch_size=750, seed=0)
    return docs, df, res.state


def test_update_step_matches_repro(warm):
    """From the same state and assignment, the port's update gives the same
    moving flags, and means/ρ_self within 1e-6."""
    docs, df, st = warm
    rng = np.random.default_rng(3)
    assign = np.asarray(st.assign).copy()
    flip = rng.random(assign.shape[0]) < 0.1
    assign[flip] = rng.integers(0, 16, flip.sum())
    want = jup.update_step(docs, jnp.asarray(assign), st.assign, st,
                           st.index.params, k=16, backend="reference")
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    tst = state_from_numpy(st.index.means_t, st.index.moving,
                           st.index.params.t_th, st.index.params.v_th,
                           st.assign, st.rho_self, st.rho_self_prev,
                           st.iteration, st.ub, device="cpu")
    got = tup.update_step(tdocs, _t(assign), tst.assign, tst,
                          tst.index.params, k=16, backend=KernelBackend())
    np.testing.assert_array_equal(np.asarray(want.index.moving),
                                  got.index.moving.numpy())
    np.testing.assert_array_equal(np.asarray(want.index.mf),
                                  got.index.mf.numpy())
    np.testing.assert_allclose(np.asarray(want.index.means_t),
                               got.index.means_t.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(want.rho_self),
                               got.rho_self.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(want.ub), got.ub.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert int(want.iteration) == got.iteration
    np.testing.assert_array_equal(np.asarray(want.xstate),
                                  got.xstate.numpy())


@pytest.mark.parametrize("grid", [dict(), dict(n_v=6, n_s=12)])
def test_estimate_params_identical(warm, grid):
    docs, df, st = warm
    want, _ = jestimate(docs, df, st.index.means_t, st.rho_self, k=16,
                        grid=JGrid(**grid))
    got, aux = estimate_params(
        docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim,
                        device="cpu"),
        _t(df), _t(st.index.means_t), _t(st.rho_self), k=16,
        grid=EstGrid(**grid))
    assert got.t_th == int(want.t_th)
    assert got.v_th == float(want.v_th)
    assert aux["J"].dtype == torch.float64


class _TermMajorBackend(KernelBackend):
    """λ_t summed posting by posting over the documents' term-major
    layout, in the CUDA kernel's order."""

    def accumulate_means(self, docs, assign, *, k: int):
        tm, d = docs.by_term, docs.dim
        terms = torch.repeat_interleave(torch.arange(d), tm.ptr.diff())
        a = assign[tm.rows.long()]
        ok = (a >= 0) & (a < k)
        lam = torch.zeros(d * k)
        lam.index_add_(0, (terms * k + a.long())[ok], tm.vals[ok])
        return lam.view(d, k)


def test_update_step_with_by_term_identical(warm):
    """An update whose λ adds the documents' term-major postings in order
    (the kernel's walk) and the CPU's row-major update give identical
    states, bit for bit; the CPU update builds no layout."""
    docs, df, st = warm
    rng = np.random.default_rng(4)
    assign = np.asarray(st.assign).copy()
    flip = rng.random(assign.shape[0]) < 0.1
    assign[flip] = rng.integers(0, 16, flip.sum())
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    tst = state_from_numpy(st.index.means_t, st.index.moving,
                           st.index.params.t_th, st.index.params.v_th,
                           st.assign, st.rho_self, st.rho_self_prev,
                           st.iteration, st.ub, device="cpu")
    step = lambda bk: tup.update_step(
        tdocs, _t(assign), tst.assign, tst, tst.index.params, k=16,
        backend=bk)
    b = step(KernelBackend())
    assert "by_term" not in vars(tdocs)
    a = step(_TermMajorBackend())
    for name in ("means_t", "moving", "mf", "mf_h", "sketch_t", "n_moving"):
        assert torch.equal(getattr(a.index, name), getattr(b.index, name))
    for name in ("assign", "rho_self", "rho_self_prev", "ub"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert a.iteration == b.iteration


def test_init_state_from_explicit_seed_rows(small_corpus):
    docs, df, _, _ = small_corpus
    rows = np.asarray(jup.seed_rows(docs.n_docs, 16, seed=0))
    want = jup.init_state(docs, 16, jmi.StructuralParams.trivial(docs.dim))
    got = tup.init_state(
        docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim,
                        device="cpu"), 16,
        tmi.StructuralParams.trivial(docs.dim), seed_rows=_t(rows))
    np.testing.assert_allclose(np.asarray(want.index.means_t),
                               got.index.means_t.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert got.ub.shape == tuple(want.ub.shape)
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim,
                            device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        tup.init_state(tdocs, 3, tmi.StructuralParams.trivial(docs.dim),
                       seed_rows=torch.tensor([1, 1, 2]))


@pytest.mark.parametrize("d", [7, 32, 300, 1024, 5000, 40000])
def test_column_dots_sum_in_repro_order(d):
    """The column dots behind normalisation and drift equal repro's float32
    sums bit for bit (one ulp near a dot of 1 is a drift of 3e-4)."""
    rng = np.random.default_rng(d)
    k = 5
    a = rng.random((d, k)).astype(np.float32)
    a[rng.random((d, k)) < 0.6] = 0.0
    b = a.copy()
    b[: d // 3] = rng.random((d // 3, k)).astype(np.float32)
    want = np.asarray(jnp.sum(jnp.asarray(a) * jnp.asarray(b), axis=0))
    got = tmi.column_dots(_t(a), _t(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    old = tmi.CHUNK_ELEMS
    try:                                  # several row chunks per level
        tmi.CHUNK_ELEMS = 64
        np.testing.assert_array_equal(tmi.column_dots(_t(a), _t(b)).numpy(),
                                      want)
    finally:
        tmi.CHUNK_ELEMS = old


@pytest.mark.parametrize("k", [5, 16, 37])
def test_max_center_drift_and_group_of_match_repro(k):
    rng = np.random.default_rng(k + 1)
    old = _unit_means(rng, 300, k).T.copy()
    new = old.copy()
    new[:, :2] = _unit_means(rng, 300, 2).T            # two centroids move
    # equal dots; torch's and XLA's float32 arccos may differ by an ulp
    want = np.asarray(jup.group_drift(jnp.asarray(new), jnp.asarray(old)))
    np.testing.assert_allclose(tup.group_drift(_t(new), _t(old)).numpy(),
                               want, rtol=1e-6, atol=1e-7)
    assert float(tup.max_center_drift(_t(new), _t(old))) == pytest.approx(
        float(jup.max_center_drift(jnp.asarray(new), jnp.asarray(old))),
        rel=1e-6)
    np.testing.assert_array_equal(tup.ub_group_of(k).numpy(),
                                  np.asarray(jup.ub_group_of(k)))
