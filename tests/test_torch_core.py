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


def _bracket_case(b, p, d, k, seed):
    """(ids, vals, nnz, means (K, D)) by the numpy steps of
    tests/test_pruning.py's ``_make_case``: sorted ids, unit-norm rows over
    their dense vectors, means with 40% live entries plus 1e-3, unit rows."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, d, (b, p)), axis=1).astype(np.int32)
    vals = rng.random((b, p)).astype(np.float32)
    nnz = rng.integers(1, p + 1, b).astype(np.int32)
    for i in range(b):
        vals[i, nnz[i]:] = 0.0
        ids[i, nnz[i]:] = 0
    for i in range(b):
        dense = np.zeros(d)
        np.add.at(dense, ids[i, :nnz[i]], vals[i, :nnz[i]])
        vals[i] /= max(np.linalg.norm(dense), 1e-9)
    means = np.where(rng.random((k, d)) < 0.4, rng.random((k, d)), 0.0)
    means += 1e-3
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    return ids, vals, nnz, means.astype(np.float32)


def test_bracket_case_gap_is_shared_with_repro():
    """The case whose bracket check fails in ``repro`` (tests/test_pruning.py:
    b 2, p 2, d 8, K 9, t_th 0, one drift of scale 2^-7, seed 0): its
    loosened group bound lies 3.39e-5 under the true group max, above the
    check's 2e-5 slack.  From ``repro``'s refreshed bound, the port's
    column dots equal ``repro``'s bit for bit, its drift is within one
    float32 ulp (the arccos rounded from float64, by design) and its
    loosened bound within 1e-6; at the failing (row, group) the loosened
    bound is ``repro``'s bit for bit, so the worst gap is the same number:
    ``repro``'s bound's, shared by the port, no fault of its own."""
    from repro.core import StructuralParams as JParams
    from repro.core import build_mean_index as jbuild
    from repro.core.assignment import _scan, assignment_step
    from repro.sparse import SparseDocs

    b, k, scale, seed = 2, 9, 0.0078125, 0
    ids, vals, nnz, means = _bracket_case(b, 2, 8, k, seed)
    docs = SparseDocs(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                      nnz=jnp.asarray(nnz), dim=8)
    params = JParams(t_th=jnp.asarray(0, jnp.int32),
                     v_th=jnp.asarray(0.1, jnp.float32))

    def sims_at(m):
        return np.asarray(_scan(docs, jbuild(jnp.asarray(m), params),
                                jnp.zeros((b,), bool), mode="esicp")["sims"])

    sims = sims_at(means)
    assign = sims.argmax(axis=1).astype(np.int32)
    res = assignment_step("bounds", docs, jbuild(jnp.asarray(means), params),
                          jnp.asarray(assign), jnp.asarray(sims.max(axis=1)),
                          jnp.zeros((b,), bool))
    ub = np.asarray(res.ub)
    rng = np.random.default_rng(seed + 1)
    new = means + scale * rng.normal(size=means.shape).astype(np.float32) \
        * rng.random(k).astype(np.float32)[:, None]
    new /= np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-9)
    new_t, old_t = new.T.copy(), means.T.copy()
    np.testing.assert_array_equal(
        tup.column_dots(_t(new_t), _t(old_t)).numpy(),
        np.asarray(jnp.sum(jnp.asarray(new_t) * jnp.asarray(old_t), axis=0)))
    want = np.asarray(jup.group_drift(jnp.asarray(new_t), jnp.asarray(old_t)))
    got = tup.group_drift(_t(new_t), _t(old_t)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    loose_j = np.asarray(jup.drift_loosen(jnp.asarray(ub), jnp.asarray(want)))
    loose_t = tup.drift_loosen(_t(ub), _t(got)).numpy()
    np.testing.assert_allclose(loose_t, loose_j, rtol=0, atol=1e-6)
    # the true best non-assigned similarity of each (row, group) at the
    # drifted means, as the bracket check takes it
    true = np.array(sims_at(new), np.float64)
    true[np.arange(b), assign] = -np.inf
    g, gsz = jup.n_ub_groups(k), jup.ub_group_size(k)
    true = np.pad(true, ((0, 0), (0, g * gsz - k)),
                  constant_values=-np.inf).reshape(b, g, gsz).max(axis=2)
    live = np.isfinite(loose_j) & np.isfinite(true)
    gap_j, gap_t = np.full_like(true, -np.inf), np.full_like(true, -np.inf)
    gap_j[live] = true[live] - loose_j[live]
    gap_t[live] = true[live] - loose_t[live]
    worst = np.unravel_index(gap_j.argmax(), gap_j.shape)
    assert np.unravel_index(gap_t.argmax(), gap_t.shape) == worst
    assert loose_t[worst] == loose_j[worst] and gap_t.max() == gap_j.max()


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
