"""The port's nine assignment modes against ``repro``'s, on the CPU.

``repro`` runs its reference backend (the TAAT scan, its exactness oracle).
Three checks, each parametrised over the modes:

* one ``assign_batch`` from a warm state (``repro``'s bounds-esicp fit
  after three iterations, so the thresholds are EstParams' and most
  per-group bounds are finite): identical assignments, |Z_i|, Mult and
  pattern of infinities in the refreshed bounds ``ub``; finite bounds and
  ρ within 1e-5 (float32 sums in another order);
* every mode's assignments from that state equal MIVI's;
* a ``lloyd_fit`` trajectory from ``repro``'s seed rows against
  ``repro``'s fit stepped iteration by iteration: the same assignment
  after every iteration and the same integer history (Mult, |Z|, changed,
  n_moving, t_th) and v_th.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import assignment as ja  # noqa: E402
from repro.core import lloyd as jl  # noqa: E402
from repro.core.estparams import estimate_params as jestimate  # noqa: E402
from repro.core.meanindex import StructuralParams as JParams  # noqa: E402
from repro.core.update import init_state as jinit  # noqa: E402
from repro.core.update import seed_rows as jseed_rows  # noqa: E402

from repro_torch.convert import docs_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core import assignment as ta  # noqa: E402
from repro_torch.core.backends import KernelBackend  # noqa: E402
from repro_torch.core.lloyd import lloyd_fit  # noqa: E402

K = 16
BS = 750
MODES = sorted(ta.ALGORITHMS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work.  Its tensors are
    small, and with the suite's workers each starting one OpenMP thread
    per core the threads oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def warm(small_corpus):
    docs, df, _, _ = small_corpus
    res = jl.lloyd_fit(docs, k=K, algo="bounds-esicp", backend="reference",
                       max_iter=3, batch_size=BS, seed=0)
    st = res.state
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    tst = state_from_numpy(st.index.means_t, st.index.moving,
                           st.index.params.t_th, st.index.params.v_th,
                           st.assign, st.rho_self, st.rho_self_prev,
                           st.iteration, st.ub, device="cpu")
    return docs, st, tdocs, tst


@pytest.fixture(scope="module")
def mivi_assign(warm):
    _, _, tdocs, tst = warm
    return ta.assign_batch("mivi", KernelBackend(), tdocs, tst.index,
                           tst.assign, tst.rho_self, tst.xstate,
                           tst.ub).assign


def test_all_nine_modes_are_ported():
    assert set(ta.ALGORITHMS) == set(ja.ALGORITHMS)


@pytest.mark.parametrize("algo", MODES)
def test_assign_batch_matches_repro(warm, mivi_assign, algo):
    docs, st, tdocs, tst = warm
    assert 0.5 < float(np.isfinite(np.asarray(st.ub)).mean()) < 1.0
    want = ja.assign_batch(algo, "reference", docs, st.index, st.assign,
                           st.rho_self, st.xstate, None, st.ub)
    got = ta.assign_batch(algo, KernelBackend(), tdocs, tst.index,
                          tst.assign, tst.rho_self, tst.xstate, tst.ub)
    np.testing.assert_array_equal(np.asarray(want.assign), got.assign.numpy())
    np.testing.assert_array_equal(np.asarray(want.n_candidates),
                                  got.n_candidates.numpy())
    np.testing.assert_array_equal(np.asarray(want.changed),
                                  got.changed.numpy())
    assert got.mult.dtype == torch.int64
    assert int(got.mult) == int(want.mult)
    w_ub, g_ub = np.asarray(want.ub), got.ub.numpy()
    for pattern in (np.isposinf, np.isneginf, np.isfinite):
        np.testing.assert_array_equal(pattern(w_ub), pattern(g_ub))
    fin = np.isfinite(w_ub)
    np.testing.assert_allclose(g_ub[fin], w_ub[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho),
                               rtol=1e-5, atol=1e-5)
    # exact by contract: the same assignments as MIVI from the same state
    assert torch.equal(got.assign, mivi_assign)


def test_second_best_and_group_bounds_match_repro(warm):
    docs, st, tdocs, tst = warm
    out = KernelBackend().accumulate(tdocs, tst.index, tst.xstate,
                                     mode="exact")
    sims, assign = out["sims"], tst.assign
    js, ja_ = jnp.asarray(sims.numpy()), jnp.asarray(assign.numpy())
    np.testing.assert_array_equal(ta._second_best(sims, assign).numpy(),
                                  np.asarray(ja._second_best(js, ja_)))
    np.testing.assert_array_equal(ta._group_bounds(sims, assign, K).numpy(),
                                  np.asarray(ja._group_bounds(js, ja_, K)))


def test_bounds_esicp_takes_the_epoch_region3_sketch(warm):
    """The Region-3 sketch passed down once per epoch gives the same step
    as the one computed per batch; other modes refuse it."""
    from repro_torch.core.meanindex import region3_sketch

    _, _, tdocs, tst = warm
    args = (KernelBackend(), tdocs, tst.index, tst.assign, tst.rho_self,
            tst.xstate, tst.ub)
    a = ta.assign_batch("bounds-esicp", *args)
    b = ta.assign_batch("bounds-esicp", *args,
                        r3_sketch=region3_sketch(tst.index))
    assert int(a.mult) == int(b.mult)
    assert torch.equal(a.ub, b.ub) and torch.equal(a.n_candidates,
                                                   b.n_candidates)
    with pytest.raises(ValueError, match="bounds-esicp"):
        ta.assign_batch("sketch", *args, r3_sketch=region3_sketch(tst.index))


def _repro_steps(algo, docs, df, max_iter):
    """repro's fit stepped on the host (its own ``_device_iteration`` plus
    EstParams at iterations 1–2): the assignment and the history integers
    after every iteration."""
    state = jinit(docs, K, JParams.trivial(docs.dim), seed=0)
    valid = jnp.ones((docs.n_docs,), bool)
    traj, hist = [], []
    for r in range(1, max_iter + 1):
        state, (mult, cand, n_changed, _) = jl._device_iteration(
            algo, "reference", docs, state, valid, bs=BS, k=K)
        if r in (1, 2):
            params, _ = jestimate(docs, df, state.index.means_t,
                                  state.rho_self, k=K)
            state = state.__class__(
                index=state.index.with_params(params), assign=state.assign,
                rho_self=state.rho_self, rho_self_prev=state.rho_self_prev,
                iteration=state.iteration, ub=state.ub)
        traj.append(np.asarray(state.assign))
        hist.append({"mult": int(mult), "n_candidates": int(cand),
                     "n_changed": int(n_changed),
                     "n_moving": int(state.index.n_moving),
                     "t_th": int(state.index.params.t_th),
                     "v_th": float(state.index.params.v_th)})
        if hist[-1]["n_changed"] == 0:
            break
    return traj, hist


@pytest.mark.parametrize("algo", ["sketch", "bounds-esicp", "ta-icp",
                                  "cs-icp"])
def test_fit_trajectory_matches_repro(small_corpus, algo):
    docs, df, _, _ = small_corpus
    traj, hist = _repro_steps(algo, docs, df, max_iter=30)
    rows = np.array(jseed_rows(docs.n_docs, K, seed=0))
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    got = lloyd_fit(tdocs, k=K, algo=algo, batch_size=BS, max_iter=30,
                    seed_rows=torch.from_numpy(rows), device="cpu",
                    keep_trajectory=True)
    assert got.n_iter == len(hist)
    for r, (a, b, hw, hg) in enumerate(zip(traj, got.trajectory, hist,
                                           got.history), start=1):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"iteration {r}")
        assert hw == {f: hg[f] for f in hw}, f"iteration {r}"
