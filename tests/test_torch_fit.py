"""End to end: the port's ES-ICP fit and classify against ``repro``'s.

The fit runs ``repro.core.lloyd.lloyd_fit(backend="reference",
algo="esicp")`` (through ``repro.cluster.fit``) and the port's ``lloyd_fit`` from the same seed rows (torch
cannot reproduce ``jax.random.choice``, so the port takes ``repro``'s rows)
on the shared 1500×1024 corpus at k=16: the assignment after every
iteration, the iteration count and the integer history must be identical,
and the objective within 1e-5 (float32 sums in another order).  Also: a
``repro``-fitted model carried over classifies identically, the package
stays free of JAX and ``repro``, and a default-device entry point raises
without a GPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lloyd as jl  # noqa: E402
from repro.core.estparams import estimate_params as jestimate  # noqa: E402
from repro.core.meanindex import StructuralParams as JParams  # noqa: E402
from repro.core.update import init_state as jinit  # noqa: E402
from repro.core.update import seed_rows as jseed_rows  # noqa: E402
import repro.cluster as jcluster  # noqa: E402

import repro_torch.cluster as tcluster  # noqa: E402
from repro_torch.convert import docs_from_numpy, model_from_numpy  # noqa: E402
from repro_torch.core.lloyd import lloyd_fit  # noqa: E402
from repro_torch.data import CorpusSpec, make_corpus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

K = 16
BS = 750
INTS = ("mult", "n_changed", "n_moving", "t_th")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work.  Its tensors are
    small, and with the suite's workers each starting one OpenMP thread
    per core the threads oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repro_trajectory(docs, df, rows_state, max_iter):
    """repro's fit stepped on the host — the prologue's own iteration
    (``_device_iteration``) plus EstParams at iterations 1–2 — keeping the
    assignment after every iteration."""
    state = rows_state
    n = docs.n_docs
    valid = jnp.ones((n,), bool)
    traj, changed = [], []
    for r in range(1, max_iter + 1):
        state, (_, _, n_changed, _) = jl._device_iteration(
            "esicp", "reference", docs, state, valid, bs=BS, k=K)
        if r in (1, 2):
            params, _ = jestimate(docs, df, state.index.means_t,
                                  state.rho_self, k=K)
            state = state.__class__(
                index=state.index.with_params(params), assign=state.assign,
                rho_self=state.rho_self, rho_self_prev=state.rho_self_prev,
                iteration=state.iteration, ub=state.ub)
        traj.append(np.asarray(state.assign))
        changed.append(int(n_changed))
        if changed[-1] == 0:
            break
    return traj, changed


@pytest.fixture(scope="module")
def fits(small_corpus):
    """repro's fitted model (repro.cluster.fit = lloyd_fit on the reference
    backend, algo esicp) and the port's lloyd_fit from the same seed rows."""
    docs, df, _, _ = small_corpus
    want = jcluster.fit(docs, jcluster.ClusterConfig(
        k=K, algo="esicp", backend="reference", batch_size=BS, seed=0),
        df=df)
    rows = np.array(jseed_rows(docs.n_docs, K, seed=0))
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    got = lloyd_fit(tdocs, k=K, algo="esicp", batch_size=BS,
                    seed_rows=torch.from_numpy(rows), device="cpu",
                    keep_trajectory=True)
    return docs, df, tdocs, rows, want, got


def test_fit_history_and_result_identical(fits):
    _, _, _, _, want, got = fits
    assert got.n_iter == want.n_iter
    assert got.converged == want.converged
    for hw, hg in zip(want.history, got.history):
        assert {f: hw[f] for f in INTS} == {f: hg[f] for f in INTS}
        assert hw["v_th"] == hg["v_th"]
        assert hg["n_candidates"] == round(hw["cpr"] * 1500 * K)
        assert hg["objective"] == pytest.approx(hw["objective"], rel=1e-5)
    np.testing.assert_array_equal(want.labels, got.assign.numpy())
    assert got.objective == pytest.approx(want.objective, rel=1e-5)


def test_fit_assignment_trajectory_identical(fits):
    docs, df, _, _, want, got = fits
    state0 = jinit(docs, K, JParams.trivial(docs.dim), seed=0)
    traj, changed = _repro_trajectory(docs, df, state0, want.n_iter)
    assert changed == [h["n_changed"] for h in want.history]
    assert len(traj) == len(got.trajectory) == want.n_iter
    for r, (a, b) in enumerate(zip(traj, got.trajectory), start=1):
        np.testing.assert_array_equal(a, b.numpy(),
                                      err_msg=f"iteration {r}")


def test_cluster_fit_front_door(fits):
    """repro_torch.cluster.fit is lloyd_fit behind a ClusterConfig, and its
    model's predict is classify_docs."""
    _, _, tdocs, rows, _, got = fits
    model = tcluster.fit(tdocs, tcluster.ClusterConfig(
        k=K, batch_size=BS, device="cpu"),
        seed_rows=torch.from_numpy(rows))
    np.testing.assert_array_equal(model.labels.numpy(), got.assign.numpy())
    assert [h["mult"] for h in model.history] == \
        [h["mult"] for h in got.history]
    labels, sims = tcluster.classify_docs(model.index, tdocs, batch_size=500)
    np.testing.assert_array_equal(labels.numpy(),
                                  model.predict(tdocs).numpy())
    # classify scores every doc at least at its own centroid's similarity
    assert bool((sims >= model.rho_self - 1e-6).all())


def test_repro_model_classifies_identically(fits):
    docs, _, tdocs, _, jm, _ = fits
    want_a, want_s = jcluster.classify_docs(jm.index, docs,
                                            backend="reference",
                                            batch_size=BS)
    tm = model_from_numpy(jm.index.means_t, jm.index.moving,
                          int(jm.index.params.t_th),
                          float(jm.index.params.v_th), labels=jm.labels,
                          rho_self=jm.rho_self, history=jm.history,
                          device="cpu")
    ops.reset_counts()
    got_a, got_s = tcluster.classify_docs(tm.index, tdocs, batch_size=BS)
    np.testing.assert_array_equal(np.asarray(want_a), got_a.numpy())
    np.testing.assert_allclose(np.asarray(want_s), got_s.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert ops.PLAIN["sparse_sim"] == 2 and ops.LAUNCHES["sparse_sim"] == 0
    np.testing.assert_array_equal(tm.labels.numpy(), jm.labels)
    assert tm.objective == pytest.approx(jm.objective, rel=1e-6)


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU rule cannot show")
    spec = CorpusSpec(n_docs=20, vocab=64, nt_mean=5, n_topics=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_corpus(spec)
    docs, _, _, _ = make_corpus(spec, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcluster.fit(docs, tcluster.ClusterConfig(k=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lloyd_fit(docs, k=2)


PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_package_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.cluster, repro_torch.convert,"
            " repro_torch.kernels.ops, repro_torch.core.lloyd,"
            " repro_torch.data;"
            " import repro_torch.kernels.esicp_gather,"
            " repro_torch.kernels.sparse_sim, repro_torch.kernels.esicp_filter,"
            " repro_torch.kernels.segment_update,"
            " repro_torch.kernels.rho_gather,"
            " repro_torch.kernels.flash_attention, repro_torch.serve.lm,"
            " repro_torch.models.transformer, repro_torch.configs.registry,"
            " repro_torch.configs.gemma3_1b, repro_torch.checkpoint,"
            " repro_torch.sparse.store, repro_torch.core.metrics,"
            " repro_torch.data.loader, repro_torch.cluster.estimator;"
            " bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    offenders = []
    for path in PKG.rglob("*.py"):
        for ln in path.read_text().splitlines():
            s = ln.strip()
            if (s.startswith(("import jax", "from jax"))
                    or s.startswith(("import repro ", "from repro."))
                    or s == "import repro"
                    or (s.startswith("import repro.") and
                        not s.startswith("import repro_torch"))):
                offenders.append(f"{path.name}: {s}")
    assert not offenders, offenders
