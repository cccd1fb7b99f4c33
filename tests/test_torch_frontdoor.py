"""The port's front door against ``repro``'s, on the CPU: save/load of the
fitted model in both directions, transform and score, classify and
transform over a DocStore, the ``SphericalKMeans`` estimator and its
strategies, the metrics, ``l1_tail`` and ``load_uci_bow``."""
import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.cluster as jcluster  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core.update import seed_rows as jseed_rows  # noqa: E402
from repro.data import load_uci_bow as jload_uci_bow  # noqa: E402
from repro.sparse import l1_tail as jl1_tail  # noqa: E402

import repro_torch.cluster as tcluster  # noqa: E402
from repro_torch.cluster import (ClusterConfig, FittedModel,  # noqa: E402
                                 SphericalKMeans, classify_docs, load_model,
                                 resolve_strategy, transform_docs)
from repro_torch.convert import docs_from_numpy, model_from_numpy  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.data import load_uci_bow  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.sparse import DocStore, l1_tail  # noqa: E402

K = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work.  Its tensors are
    small, and with the suite's workers each starting one OpenMP thread
    per core the threads oversubscribe the host: six workers on eight
    cores ran this module about 8x slower than with one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted(small_corpus):
    """repro's fitted model (reference backend) and the port's estimator
    fit from repro's seed rows, on the 1500×1024 corpus."""
    docs, df, _, _ = small_corpus
    jm = jcluster.fit(docs, jcluster.ClusterConfig(
        k=K, algo="esicp", backend="reference", batch_size=750, seed=0),
        df=df)
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    rows = torch.from_numpy(np.array(jseed_rows(1500, K, seed=0)))
    km = SphericalKMeans(K, batch_size=750, device="cpu").fit(
        tdocs, seed_rows=rows)
    return docs, tdocs, rows, jm, km


def test_estimator_fit_is_the_resident_fit(fitted):
    """The estimator's fit is repro's fit (labels, iterations, history
    integers), and cluster.fit goes through it."""
    _, tdocs, rows, jm, km = fitted
    assert km.model_.strategy == "single_host" and km.converged_
    assert km.n_iter_ == jm.n_iter
    assert km.history_ == km.model_.history
    assert [h["mult"] for h in km.history_] == \
        [h["mult"] for h in jm.history]
    assert km.params_ == type(km.params_)(int(jm.params.t_th),
                                          float(jm.params.v_th))
    assert km.objective_ == pytest.approx(jm.objective, rel=1e-5)
    np.testing.assert_array_equal(km.labels_.numpy(), jm.labels)
    assert torch.equal(km.predict(tdocs), km.labels_)
    # cluster.fit goes through the estimator, seed rows and trajectory kept
    m = tcluster.fit(tdocs, ClusterConfig(k=K, batch_size=750,
                                          device="cpu"),
                     seed_rows=rows, keep_trajectory=True)
    assert torch.equal(m.labels, km.labels_)
    assert len(m.trajectory) == m.n_iter
    assert torch.equal(m.trajectory[-1], km.labels_)


def test_transform_and_score_match_repro(fitted):
    docs, tdocs, _, jm, km = fitted
    tm = model_from_numpy(jm.index.means_t, jm.index.moving,
                          int(jm.index.params.t_th),
                          float(jm.index.params.v_th), device="cpu")
    want = np.asarray(jm.transform(docs))
    got = tm.transform(tdocs, batch_size=500)
    assert got.shape == (1500, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tm.score(tdocs) == pytest.approx(jm.score(docs), rel=1e-5)
    assert torch.equal(km.transform(tdocs),
                       transform_docs(km.model_.index, tdocs))
    assert km.score(tdocs) >= km.objective_ - 1e-3


def test_repro_saved_model_loads_in_the_port(fitted, tmp_path):
    docs, tdocs, _, jm, _ = fitted
    path = str(tmp_path / "m")
    jm.save(path)
    tm = load_model(path, device="cpu")
    assert (tm.k, tm.dim, tm.algo, tm.backend) == (K, 1024, "esicp",
                                                   "reference")
    assert tm.n_iter == jm.n_iter and tm.history == jm.history
    np.testing.assert_array_equal(tm.labels.numpy(), jm.labels)
    np.testing.assert_array_equal(tm.index.means_t.numpy(),
                                  np.asarray(jm.index.means_t))
    assert tm.params == type(tm.params)(int(jm.params.t_th),
                                        float(jm.params.v_th))
    np.testing.assert_array_equal(tm.predict(tdocs).numpy(),
                                  np.asarray(jm.predict(docs)))


def test_port_saved_model_loads_in_repro(fitted, tmp_path):
    docs, tdocs, _, _, km = fitted
    path = str(tmp_path / "m")
    km.model_.save(path, step=4)
    jm = jcluster.FittedModel.load(path)
    with open(os.path.join(path, "step_00000004", "extra.json")) as f:
        extra = json.load(f)
    assert extra["runtime"] == "repro_torch" and extra["device"] == "cpu"
    assert jm.backend == "auto" and jm.strategy == "single_host"
    np.testing.assert_array_equal(jm.labels, km.labels_.numpy())
    np.testing.assert_array_equal(np.asarray(jm.predict(docs)),
                                  km.predict(tdocs).numpy())
    back = FittedModel.load(path, device="cpu")
    assert torch.equal(back.index.means_t, km.model_.index.means_t)
    assert torch.equal(back.index.moving, km.model_.index.moving)
    assert back.params == km.model_.params
    assert back.history == km.history_ and back.cursor is None
    assert torch.equal(back.predict(tdocs), km.predict(tdocs))


def test_model_load_refuses_other_artifacts(tmp_path):
    from repro_torch.checkpoint.store import save_checkpoint

    from repro_torch.cluster import TwoLevelFittedModel

    save_checkpoint(str(tmp_path / "a"), {"x": np.zeros(2)}, step=0,
                    extra={"format": "repro.cluster/fitted-model-v1"})
    with pytest.raises(ValueError, match="fitted-two-level-v1"):
        TwoLevelFittedModel.load(str(tmp_path / "a"), device="cpu")
    save_checkpoint(str(tmp_path / "b"), {"x": np.zeros(2)}, step=0,
                    extra={"format": "other"})
    with pytest.raises(ValueError, match="fitted-model-v1"):
        load_model(str(tmp_path / "b"), device="cpu")


@pytest.mark.parametrize("chunk", [None, 400])
def test_classify_and_transform_over_store(fitted, chunk):
    _, tdocs, _, _, km = fitted
    index = km.model_.index
    store = DocStore.from_docs(tdocs, chunk_size=chunk)
    a, s = classify_docs(index, tdocs, batch_size=300)
    ops.reset_counts()
    sa, ss = classify_docs(index, store, batch_size=300)
    assert torch.equal(sa, a) and torch.equal(ss, s)
    # one launch per batch of each chunk's real rows: 2+2+2+1, or 5
    assert ops.PLAIN["sparse_sim"] == (7 if chunk else 5)
    assert torch.equal(transform_docs(index, store, batch_size=300),
                       transform_docs(index, tdocs))
    assert torch.equal(km.model_.predict(store), a)


def test_store_input_promotes_to_streaming(fitted):
    _, tdocs, rows, _, km = fitted
    store = DocStore.from_docs(tdocs, chunk_size=500)
    cfg = ClusterConfig(k=K, device="cpu")
    assert resolve_strategy(cfg, tdocs).name == "single_host"
    assert resolve_strategy(cfg, store).name == "streaming"
    assert resolve_strategy(cfg.replace(algo_mode="minibatch"),
                            tdocs).name == "streaming"
    got = SphericalKMeans(K, batch_size=750, device="cpu").fit(
        store, seed_rows=rows)
    assert got.model_.strategy == "streaming"
    assert torch.equal(got.labels_, km.labels_)
    assert got.history_[-1]["mult"] == km.history_[-1]["mult"]
    # resident docs with algo_mode='minibatch' run on the streaming fit
    mb = SphericalKMeans(K, algo_mode="minibatch", max_iter=2,
                         chunk_size=500, device="cpu").fit(tdocs,
                                                           seed_rows=rows)
    assert mb.model_.strategy == "streaming" and mb.n_iter_ == 2
    assert mb.model_.cursor == (3, 0) and not mb.converged_


def test_estimator_surface_and_unported_runtimes(fitted):
    _, tdocs, _, _, _ = fitted
    head = tdocs.slice_rows(0, 300)
    small = SphericalKMeans(4, max_iter=3, device="cpu")
    labels = small.fit_predict(head, seed_rows=torch.arange(4))
    assert torch.equal(labels, small.labels_) and labels.shape == (300,)
    assert torch.equal(small.predict(head), small.model_.predict(head))
    km = SphericalKMeans(8, algo="bounds", chunk_size=64, device="cpu",
                         checkpoint_every=2)
    cfg = km.config
    assert (cfg.k, cfg.algo, cfg.chunk_size, cfg.device,
            cfg.checkpoint_every, cfg.strategy) == (8, "bounds", 64, "cpu",
                                                    2, "single_host")
    assert SphericalKMeans.from_config(cfg).config == cfg
    with pytest.raises(AttributeError, match="not fitted"):
        km.predict(None)
    with pytest.raises(AttributeError, match="only available after fit"):
        km.labels_
    # The mesh runtime is ported: the front door refuses what repro's
    # refuses there (tests/test_torch_mesh.py fits on it).
    with pytest.raises(ValueError, match="not available on the mesh"):
        SphericalKMeans(8, algo="es", device="cpu",
                        mesh=make_test_mesh((1, 1), device="cpu")).fit(None)
    # The autotuner is ported: on the CPU it is a no-op (no tiles to tune).
    tuned = SphericalKMeans(4, max_iter=3, device="cpu", tune="cached",
                            tune_budget=2).fit(head,
                                               seed_rows=torch.arange(4))
    assert torch.equal(tuned.labels_, small.labels_)
    assert tuned.model_.cuda_tuned is None
    with pytest.raises(ValueError, match="coarse_k must be < k"):
        SphericalKMeans(8, coarse_k=8, device="cpu").fit(None)
    with pytest.raises(ValueError, match="algo_mode"):
        ClusterConfig(k=2, algo_mode="sgd").validate()
    with pytest.raises(ValueError, match="tune"):
        ClusterConfig(k=2, tune="fast").validate()
    with pytest.raises(ValueError, match="unknown algorithm"):
        ClusterConfig(k=2, algo="nope").validate()


def test_default_device_entry_points_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU rule cannot show")
    docs = docs_from_numpy(np.zeros((2, 1), np.int32), np.ones((2, 1),
                                                               np.float32),
                           np.ones(2, np.int32), 4, device="cpu")
    store = DocStore.from_docs(docs)
    for call in (lambda: store.chunk(0), lambda: store.to_docs(),
                 lambda: store.gather_rows([0]),
                 lambda: SphericalKMeans(1).fit(store),
                 lambda: load_model(str(tmp_path)),
                 lambda: load_uci_bow(str(tmp_path / "x"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# Metrics, l1_tail, load_uci_bow.
# ---------------------------------------------------------------------------

def test_metrics_match_repro(fitted):
    docs, tdocs, _, jm, km = fitted
    a = km.labels_
    b = torch.from_numpy(np.random.default_rng(1).integers(0, 7, 1500))
    assert metrics.nmi(a, b) == jmetrics.nmi(a.numpy(), b.numpy())
    assert metrics.nmi(a, a) == pytest.approx(1.0)
    runs = [a, b, (a + 1) % K]
    assert metrics.pairwise_nmi(runs) == jmetrics.pairwise_nmi(
        [r.numpy() for r in runs])
    sizes = torch.bincount(a, minlength=K)
    assert metrics.coefficient_of_variation(sizes) == \
        jmetrics.coefficient_of_variation(sizes.numpy())
    assert metrics.zipf_fit(tdocs.df) == jmetrics.zipf_fit(
        np.asarray(docs.df))
    assert metrics.objective(km.model_.rho_self) == pytest.approx(
        jmetrics.objective(jm.rho_self), rel=1e-6)
    means_t = km.model_.index.means_t
    nr, mean, std = metrics.cps_curve(tdocs, means_t, a)
    jnr, jmean, jstd = jmetrics.cps_curve(docs, jnp.asarray(means_t.numpy()),
                                          a.numpy())
    np.testing.assert_array_equal(nr, jnr)
    np.testing.assert_allclose(mean, jmean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std, jstd, rtol=1e-4, atol=1e-6)
    assert mean[0] == 0.0 and mean[-1] == pytest.approx(1.0, abs=1e-6)
    got = metrics.mean_value_skew(means_t)
    want = jmetrics.mean_value_skew(jnp.asarray(means_t.numpy()))
    assert got["frac_dominant"] == want["frac_dominant"]
    assert got["top1_mass_mean"] == pytest.approx(want["top1_mass_mean"],
                                                  rel=1e-6)


def test_l1_tail_matches_repro(fitted):
    docs, tdocs, _, _, _ = fitted
    for t_th in (0, 300, 1023, 2000):
        np.testing.assert_allclose(l1_tail(tdocs, t_th).numpy(),
                                   np.asarray(jl1_tail(docs, t_th)),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gz", [False, True])
def test_load_uci_bow_matches_repro(tmp_path, gz):
    rng = np.random.default_rng(5)
    n, d = 40, 30
    lines = []
    for doc in range(1, n + 1):
        for term in sorted(rng.choice(d, size=int(rng.integers(1, 9)),
                                      replace=False)):
            lines.append(f"{doc} {term + 1} {int(rng.integers(1, 6))}")
    order = rng.permutation(len(lines))            # triples in any order
    txt = f"{n}\n{d}\n{len(lines)}\n" + "\n".join(
        lines[i] for i in order) + "\n"
    path = str(tmp_path / ("docword.t.txt" + (".gz" if gz else "")))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        f.write(txt)
    for kw in ({}, dict(max_docs=25, pad_to=5)):
        jd, jdf, jperm = jload_uci_bow(path, **kw)
        td, tdf, tperm = load_uci_bow(path, device="cpu", **kw)
        assert (td.n_docs, td.dim, td.pad_width) == (jd.n_docs, jd.dim,
                                                     jd.pad_width)
        np.testing.assert_array_equal(td.ids.numpy(), np.asarray(jd.ids))
        np.testing.assert_array_equal(td.nnz.numpy(), np.asarray(jd.nnz))
        np.testing.assert_allclose(td.vals.numpy(), np.asarray(jd.vals),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
        np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
        assert torch.equal(td.df, tdf)
