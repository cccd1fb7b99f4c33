"""The port's two-level IVF (``repro_torch.cluster.two_level``, the routed
classify and serving) against ``repro``'s, on the CPU.

Each test of ``tests/test_ivf.py`` has a counterpart here on the same
fixture (600 documents, vocab 512, K 24, K_c 4, seed 1), on
``device="cpu"``.  Beside them:

* with ``repro``'s seed rows (``repro.core.update.seed_rows``, for the
  coarse fit and every cell) the port's fit is ``repro``'s bit for bit:
  labels, cell sizes and provenance, coarse and fine means, ρ_self;
* the routed classify gives ``repro``'s assignments at n_probe 1, 2 and
  K_c, and its similarities within 1e-5.  Not bit for bit: XLA contracts
  ``repro``'s routed scan (``sims + vp * means_ext[...]``) into fused
  multiply-adds on the CPU, while the port sums rounded products in slot
  order, the arithmetic of its flat ``sparse_sim``.  What holds bit for
  bit is ``repro``'s own invariant: a routed winner's similarity is the
  flat classify's, here the port's flat one;
* ``_allocate_fine_k``, ``partition_store`` and ``two_level_from_means``
  equal ``repro``'s; a model saved by either package loads in the other
  and predicts the same;
* the plain ``routed_scan`` against a naive loop: the first maximum in
  candidate order on ties, dead slots, single-centroid cells, dead rows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster as jcluster  # noqa: E402
from repro.cluster.two_level import _allocate_fine_k as j_allocate  # noqa: E402
from repro.core.update import seed_rows as jseed_rows  # noqa: E402
from repro.data import CorpusSpec, make_corpus  # noqa: E402
from repro.sparse import DocStore as JDocStore  # noqa: E402
from repro.sparse import partition_store as jpartition  # noqa: E402

from repro_torch.cluster import (ClusterConfig, ClusterEngine,  # noqa: E402
                                 FittedModel, SphericalKMeans,
                                 TwoLevelFittedModel, classify_docs,
                                 classify_docs_routed, fit, load_model,
                                 resolve_strategy, two_level_from_means)
from repro_torch.cluster.two_level import _allocate_fine_k  # noqa: E402
from repro_torch.convert import docs_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve import ClusterServer  # noqa: E402
from repro_torch.sparse import DocStore, partition_store  # noqa: E402

K, K_C = 24, 4
CFG = dict(k=K, coarse_k=K_C, n_probe=1, max_iter=12, batch_size=200,
           seed=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (small tensors;
    the suite's workers would oversubscribe the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    """``tests/test_ivf.py``'s corpus in both packages."""
    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=600, vocab=512,
                                            nt_mean=20, n_topics=12, seed=0))
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    return docs, df, tdocs


@pytest.fixture(scope="module")
def two_level(corpus):
    """(docs, df, port docs, port model, repro model): both packages' fit
    of ``tests/test_ivf.py``'s config, the port's from ``repro``'s seed
    rows."""
    docs, df, tdocs = corpus
    jm = jcluster.fit(docs, jcluster.ClusterConfig(**CFG), df=df)
    tm = fit(tdocs, ClusterConfig(**CFG, device="cpu"), df=tdocs.df,
             seed_rows=jseed_rows)
    return docs, df, tdocs, tm, jm


# ---------------------------------------------------------------------------
# Fit: nested artifact shape and label invariants, parity with repro.
# ---------------------------------------------------------------------------

def test_two_level_fit_builds_nested_model(two_level):
    _, _, tdocs, model, _ = two_level
    assert isinstance(model, TwoLevelFittedModel)
    assert model.strategy == "two_level"
    assert model.coarse_k == K_C and model.coarse_index.k == K_C
    assert model.cell_sizes.shape == (K_C,)
    assert (model.cell_sizes >= 1).all()
    assert int(model.cell_sizes.sum()) == model.index.k
    assert len(model.cell_meta) == K_C
    assert sum(m["n_docs"] for m in model.cell_meta) == tdocs.n_docs
    labels = model.labels.numpy()
    assert labels.shape == (tdocs.n_docs,)
    assert labels.min() >= 0 and labels.max() < model.index.k
    a_coarse, _ = classify_docs(model.coarse_index, tdocs)
    cell_of_label = np.searchsorted(model.cell_starts, labels,
                                    side="right") - 1
    assert (cell_of_label == a_coarse.numpy()).all()


def test_two_level_fit_equals_repro_bitwise(two_level):
    """From ``repro``'s seed rows the fit is ``repro``'s: labels, cell
    sizes and provenance, coarse and fine means, ρ_self, history."""
    _, _, _, tm, jm = two_level
    np.testing.assert_array_equal(tm.labels.numpy(), jm.labels)
    np.testing.assert_array_equal(tm.cell_sizes, jm.cell_sizes)
    assert tm.cell_meta == jm.cell_meta
    np.testing.assert_array_equal(tm.coarse_index.means_t.numpy(),
                                  np.asarray(jm.coarse_index.means_t))
    np.testing.assert_array_equal(tm.index.means_t.numpy(),
                                  np.asarray(jm.index.means_t))
    np.testing.assert_array_equal(tm.rho_self.numpy(), jm.rho_self)
    assert tm.n_iter == jm.n_iter and tm.converged == jm.converged
    assert [h["n_changed"] for h in tm.history] == \
        [h["n_changed"] for h in jm.history]


def test_allocate_fine_k_invariants():
    sizes = np.asarray([0, 1, 7, 100, 3])
    alloc = _allocate_fine_k(sizes, 50)
    assert (alloc >= 1).all()
    assert (alloc <= np.maximum(sizes, 1)).all()
    assert int(alloc.sum()) == min(50, int(np.maximum(sizes, 1).sum()))
    assert (alloc == _allocate_fine_k(sizes, 50)).all()
    assert (_allocate_fine_k(np.asarray([5, 5, 5]), 2) == 1).all()


@pytest.mark.parametrize("seed", range(4))
def test_allocate_fine_k_equals_repro(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n_c = int(rng.integers(2, 40))
        sizes = rng.integers(0, 300, n_c) * (rng.random(n_c) < 0.8)
        k = int(rng.integers(1, 2 * int(sizes.sum()) + 3))
        np.testing.assert_array_equal(_allocate_fine_k(sizes, k),
                                      j_allocate(sizes, k))


# ---------------------------------------------------------------------------
# Routed classify: exactness, parity with repro, the scored counter.
# ---------------------------------------------------------------------------

def test_n_probe_all_is_bitwise_flat(two_level):
    """n_probe = K_c is the flat classify: assign and sims bit for bit,
    and ``scored`` is K_eff."""
    _, _, tdocs, model, _ = two_level
    a_flat, s_flat = classify_docs(model.index, tdocs, batch_size=200)
    a, s, sc = classify_docs_routed(model, tdocs, n_probe=K_C,
                                    batch_size=200, with_stats=True)
    assert torch.equal(a, a_flat) and torch.equal(s, s_flat)
    assert (sc == model.index.k).all()


@pytest.mark.parametrize("n_probe", [1, 2, K_C])
def test_routed_classify_matches_repro(two_level, n_probe):
    """``repro``'s routed assignments, its sims within 1e-5 (its scan is
    FMA-contracted on the CPU), and its ``scored``."""
    docs, _, tdocs, tm, jm = two_level
    ja, js, jsc = jcluster.classify_docs_routed(jm, docs, n_probe=n_probe,
                                                batch_size=200,
                                                with_stats=True)
    ops.reset_counts()
    a, s, sc = classify_docs_routed(tm, tdocs, n_probe=n_probe,
                                    batch_size=200, with_stats=True)
    routed = n_probe < K_C
    assert ops.PLAIN["routed_scan"] == (3 if routed else 0)
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sc.numpy(), jsc)


def test_routed_winning_sims_are_bitwise_flat(two_level):
    """Wherever the routed argmax is the flat one, its similarity is the
    flat classify's bit for bit; a miss scores no higher."""
    _, _, tdocs, model, _ = two_level
    a_flat, s_flat = classify_docs(model.index, tdocs, batch_size=200)
    for n_probe in (1, 2, 3):
        a, s = classify_docs_routed(model, tdocs, n_probe=n_probe,
                                    batch_size=200)
        hit = a == a_flat
        assert hit.float().mean() > 0.9
        assert torch.equal(s[hit], s_flat[hit])
        assert (s[~hit] <= s_flat[~hit]).all()


def test_scored_counter_respects_candidate_bound(two_level):
    _, _, tdocs, model, _ = two_level
    _, _, scored = classify_docs_routed(model, tdocs, n_probe=1,
                                        batch_size=200, with_stats=True)
    assert int(scored.max()) <= K_C + int(model.cell_sizes.max())
    assert int(scored.min()) >= K_C + int(model.cell_sizes.min())
    assert scored.dtype == torch.int32


def test_predict_uses_model_default_n_probe(two_level):
    _, _, tdocs, model, _ = two_level
    a_routed, s_routed = classify_docs_routed(model, tdocs, n_probe=1,
                                              batch_size=200)
    assert torch.equal(model.predict(tdocs, batch_size=200), a_routed)
    assert model.score(tdocs, batch_size=200) == \
        float(s_routed.double().sum())
    km = SphericalKMeans(**CFG, device="cpu").fit(tdocs, seed_rows=jseed_rows)
    assert isinstance(km.model_, TwoLevelFittedModel)
    assert torch.equal(km.labels_, model.labels)
    assert torch.equal(km.predict(tdocs), a_routed)


def test_n_probe_validation(two_level):
    _, _, tdocs, model, _ = two_level
    for bad in (0, K_C + 1, -3):
        with pytest.raises(ValueError, match="n_probe"):
            classify_docs_routed(model, tdocs, n_probe=bad)


# ---------------------------------------------------------------------------
# DocStore: partition views, the fit and the routed classify over chunks.
# ---------------------------------------------------------------------------

def test_partition_store_equals_repro(two_level):
    """The cell views hold ``repro``'s rows and chunks bit for bit (the
    parent's width, dead-row tails), and count their own df."""
    docs, _, tdocs, model, _ = two_level
    labels = np.searchsorted(model.cell_starts, model.labels.numpy(),
                             side="right") - 1
    views = partition_store(DocStore.from_docs(tdocs, chunk_size=144),
                            labels, K_C + 1, chunk_size=50)
    jviews = jpartition(JDocStore.from_docs(docs, chunk_size=144), labels,
                        K_C + 1, chunk_size=50)
    assert views[-1] is None and jviews[-1] is None
    for v, jv in zip(views[:-1], jviews[:-1]):
        np.testing.assert_array_equal(v.rows, jv.rows)
        assert (v.n_chunks, v.pad_width) == (jv.n_chunks, jv.pad_width)
        for ci in range(v.n_chunks):
            for a, b in zip(v.host_chunk(ci), jv.host_chunk(ci)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(v.df, np.asarray(jv.df))
        assert torch.equal(v.to_docs(device="cpu").ids,
                           tdocs.ids[torch.from_numpy(v.rows)])
    with pytest.raises(NotImplementedError, match="view"):
        views[0].save("unused")


def test_two_level_fit_over_store_matches_resident(two_level):
    """A DocStore fit (chunks not aligned to the corpus) runs the coarse
    and the cell fits on the streaming runtime over ``SubsetStore`` cells
    and equals the resident fit bit for bit; the routed classify over the
    store equals the resident one."""
    _, _, tdocs, model, _ = two_level
    store = DocStore.from_docs(tdocs, chunk_size=144)
    km = SphericalKMeans(**CFG, device="cpu").fit(store, df=tdocs.df,
                                                  seed_rows=jseed_rows)
    smodel = km.model_
    assert isinstance(smodel, TwoLevelFittedModel)
    assert torch.equal(smodel.labels, model.labels)
    assert torch.equal(smodel.rho_self, model.rho_self)
    assert torch.equal(smodel.index.means_t, model.index.means_t)
    a_res, s_res = classify_docs_routed(smodel, tdocs, batch_size=200)
    a_st, s_st = classify_docs_routed(smodel, store, batch_size=200)
    assert torch.equal(a_st, a_res) and torch.equal(s_st, s_res)


# ---------------------------------------------------------------------------
# Artifact: save/load, within the port and across the packages.
# ---------------------------------------------------------------------------

def test_save_load_round_trip(two_level, tmp_path):
    _, _, tdocs, model, _ = two_level
    path = str(tmp_path / "nested")
    model.save(path)
    loaded = load_model(path, device="cpu")
    assert type(loaded) is TwoLevelFittedModel
    assert loaded.coarse_k == K_C and loaded.n_probe == model.n_probe
    np.testing.assert_array_equal(loaded.cell_sizes, model.cell_sizes)
    assert loaded.cell_meta == model.cell_meta
    assert torch.equal(loaded.index.means_t, model.index.means_t)
    assert torch.equal(loaded.coarse_index.means_t, model.coarse_index.means_t)
    a0, s0 = classify_docs_routed(model, tdocs, batch_size=200)
    a1, s1 = classify_docs_routed(loaded, tdocs, batch_size=200)
    assert torch.equal(a0, a1) and torch.equal(s0, s1)
    assert type(FittedModel.load(path, device="cpu")) is TwoLevelFittedModel
    flat = str(tmp_path / "flat")
    fit(tdocs, ClusterConfig(k=4, max_iter=2, device="cpu")).save(flat)
    with pytest.raises(ValueError, match="fitted-two-level-v1"):
        TwoLevelFittedModel.load(flat, device="cpu")


def test_save_load_across_packages(two_level, tmp_path):
    """A model either package saved loads in the other as a two-level
    model and predicts the same assignments."""
    docs, _, tdocs, tm, jm = two_level
    tm.save(str(tmp_path / "port"))
    back = jcluster.load_model(str(tmp_path / "port"))
    assert type(back).__name__ == "TwoLevelFittedModel"
    np.testing.assert_array_equal(back.cell_sizes, tm.cell_sizes)
    np.testing.assert_array_equal(back.labels, tm.labels.numpy())
    np.testing.assert_array_equal(np.asarray(back.predict(docs,
                                                          batch_size=200)),
                                  tm.predict(tdocs, batch_size=200).numpy())
    jm.save(str(tmp_path / "repro"))
    there = load_model(str(tmp_path / "repro"), device="cpu")
    assert type(there) is TwoLevelFittedModel
    assert there.cell_meta == jm.cell_meta and there.n_probe == jm.n_probe
    np.testing.assert_array_equal(there.index.means_t.numpy(),
                                  np.asarray(jm.index.means_t))
    np.testing.assert_array_equal(there.predict(tdocs,
                                                batch_size=200).numpy(),
                                  np.asarray(jm.predict(docs,
                                                        batch_size=200)))


# ---------------------------------------------------------------------------
# Engine and serving plane.
# ---------------------------------------------------------------------------

def test_engine_routes_and_guards_refit(two_level):
    _, _, tdocs, model, _ = two_level
    engine = ClusterEngine.from_model(model, device="cpu")
    a_ref, s_ref = classify_docs_routed(model, tdocs)
    a, s = engine.classify(tdocs)
    assert torch.equal(a, a_ref) and torch.equal(s, s_ref)
    a_flat, s_flat = classify_docs(model.index, tdocs)
    a2, s2 = engine.classify(tdocs, n_probe=K_C)
    assert torch.equal(a2, a_flat) and torch.equal(s2, s_flat)
    with pytest.raises(NotImplementedError, match="coarse"):
        engine.refit(tdocs)
    flat = fit(tdocs, ClusterConfig(k=8, max_iter=4, batch_size=200, seed=1,
                                    device="cpu"))
    with pytest.raises(ValueError, match="n_probe"):
        ClusterEngine.from_model(flat, device="cpu").classify(tdocs,
                                                              n_probe=2)


def test_served_routed_classify_is_bit_identical(two_level):
    """The server's answers are ``classify_docs_routed``'s bit for bit, at
    the model's n_probe and at K_c (the flat path)."""
    docs, _, tdocs, model, _ = two_level
    rows = (np.asarray(docs.ids), np.asarray(docs.vals),
            np.asarray(docs.nnz))
    with ClusterServer(device="cpu", max_live_batches=2) as srv:
        for name, m in (("ivf", model),
                        ("all", dataclasses.replace(model, n_probe=K_C))):
            a_ref, s_ref = classify_docs_routed(m, tdocs)
            srv.load(name, m, batch_sizes=(64, 256))
            a, s = srv.classify(name, rows, timeout=60)
            np.testing.assert_array_equal(a, a_ref.numpy())
            np.testing.assert_array_equal(s, s_ref.numpy())


# ---------------------------------------------------------------------------
# two_level_from_means.
# ---------------------------------------------------------------------------

def test_from_means_wraps_vectors_as_fine_level(corpus):
    """The vectors become the fine level (self-classification at n_probe
    = K_c finds a unit-similarity winner), and from ``repro``'s seed rows
    the model is ``repro``'s: cell sizes, coarse and fine means."""
    docs, _, tdocs = corpus
    model = two_level_from_means(tdocs, 6, n_probe=1, max_iter=5,
                                 device="cpu", seed_rows=jseed_rows)
    assert isinstance(model, TwoLevelFittedModel) and model.coarse_k == 6
    assert model.index.k >= tdocs.n_docs
    assert int(model.cell_sizes.sum()) == model.index.k
    _, s = classify_docs_routed(model, tdocs, n_probe=6)
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)
    jm = jcluster.two_level_from_means(docs, 6, n_probe=1, max_iter=5)
    np.testing.assert_array_equal(model.cell_sizes, jm.cell_sizes)
    np.testing.assert_array_equal(model.coarse_index.means_t.numpy(),
                                  np.asarray(jm.coarse_index.means_t))
    np.testing.assert_array_equal(model.index.means_t.numpy(),
                                  np.asarray(jm.index.means_t))


# ---------------------------------------------------------------------------
# Validation at every front door.
# ---------------------------------------------------------------------------

def test_config_validates_two_level_knobs():
    with pytest.raises(ValueError, match="coarse_k must be >= 2"):
        ClusterConfig(k=8, coarse_k=1).validate()
    with pytest.raises(ValueError, match="coarse_k must be < k"):
        ClusterConfig(k=8, coarse_k=8).validate()
    with pytest.raises(ValueError, match="n_probe"):
        ClusterConfig(k=8, coarse_k=4, n_probe=0).validate()
    with pytest.raises(ValueError, match="n_probe"):
        ClusterConfig(k=8, coarse_k=4, n_probe=5).validate()
    with pytest.raises(ValueError, match="mesh"):
        ClusterConfig(k=8, coarse_k=4, mesh=object()).validate()
    assert ClusterConfig(k=8, coarse_k=4).strategy == "two_level"
    assert ClusterConfig(k=8).strategy == "single_host"


def test_estimator_and_module_front_doors_validate(corpus):
    _, _, tdocs = corpus
    with pytest.raises(ValueError, match="coarse_k"):
        SphericalKMeans(k=8, coarse_k=1, device="cpu").fit(tdocs)
    with pytest.raises(ValueError, match="n_probe"):
        fit(tdocs, ClusterConfig(k=8, coarse_k=4, n_probe=9, device="cpu"))
    with pytest.raises(ValueError, match="coarse_k"):
        resolve_strategy(ClusterConfig(k=8, coarse_k=4, n_probe=1)
                         ).fit(tdocs, ClusterConfig(k=8, device="cpu"))
    with pytest.raises(TypeError, match="callable"):
        fit(tdocs, ClusterConfig(k=8, coarse_k=4, device="cpu"),
            seed_rows=torch.arange(4))


# ---------------------------------------------------------------------------
# The routed scan's plain version against a naive loop.
# ---------------------------------------------------------------------------

def _naive_routed(ids, vals, nnz, means_t, cells, starts, sizes, cmax):
    """Row by row, candidate by candidate, in numpy float32 scalars."""
    b = ids.shape[0]
    assign = np.zeros(b, np.int32)
    best = np.zeros(b, np.float32)
    scored = np.zeros(b, np.int32)
    for i in range(b):
        top, top_col = None, None
        for r, c in enumerate(cells[i]):
            for s in range(cmax):
                if s >= sizes[c]:
                    continue               # a dead slot: -inf, never first
                col = starts[c] + s
                acc = np.float32(0.0)
                for q in range(nnz[i]):
                    if vals[i, q] != 0:
                        acc = np.float32(acc + np.float32(
                            vals[i, q] * means_t[ids[i, q], col]))
                if top is None or acc > top:
                    top, top_col = acc, col
        if top is None:                    # no live candidate
            top, top_col = np.float32(-np.inf), 0
        assign[i], best[i] = top_col, top
        scored[i] = len(starts) + sum(int(sizes[c]) for c in cells[i])
    return assign, best, scored


@pytest.mark.parametrize("n_probe", [1, 2])
def test_routed_scan_plain_empty_cells_and_short_cmax(n_probe):
    """Cells of size 0 are never scored, a row that probes only empty
    cells gets column 0 at -inf, and a cell's slots past cmax are not
    scored (``scored`` still counts the whole cell), as in the naive loop;
    the CUDA kernel is held to this on the card."""
    rng = np.random.default_rng(10 + n_probe)
    b, p, d = 30, 12, 50
    sizes = np.asarray([4, 0, 9, 0, 2], np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    k = int(sizes.sum())
    means_t = rng.random((d, k)).astype(np.float32)
    nnz = rng.integers(1, p + 1, b).astype(np.int32)
    ids = rng.integers(0, d, (b, p)).astype(np.int32)
    vals = rng.random((b, p)).astype(np.float32)
    cells = np.stack([rng.permutation(5)[:n_probe] for _ in range(b)])
    cells[:4] = [1, 3][:n_probe]
    cells = cells.astype(np.int32)
    cmax = 6                                   # cell 2 holds 9
    want = _naive_routed(ids, vals, nnz, means_t, cells, starts, sizes, cmax)
    t = torch.from_numpy
    got = ops.routed_scan(t(ids), t(vals), t(nnz), t(means_t), t(cells),
                          t(starts), t(sizes), cmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0][:4].numpy() == 0).all()
    assert (got[1][:4].numpy() == -np.inf).all()
    in_two = got[0].numpy()[(cells == 2).any(1)]
    assert not ((in_two >= starts[2] + cmax)
                & (in_two < starts[2] + sizes[2])).any()


@pytest.mark.parametrize("n_probe", [1, 3])
def test_routed_scan_plain_equals_naive_loop(n_probe):
    """Ties between candidates go to the first in candidate order (probe
    rank, then slot: a later-ranked cell with a lower id loses), slots
    past a cell's size never win, single-centroid cells, dead rows (nnz
    0: the first candidate at 0) and garbage past nnz (never read)."""
    rng = np.random.default_rng(n_probe)
    b, p, d = 40, 17, 60
    sizes = np.asarray([3, 1, 5, 3, 2], np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    k = int(sizes.sum())
    means_t = rng.random((d, k)).astype(np.float32)
    means_t[rng.random((d, k)) < 0.4] = 0.0
    means_t[:, starts[3]:starts[3] + 3] = means_t[:, 0:3]   # cell 3 == 0
    nnz = rng.integers(0, p + 1, b).astype(np.int32)
    nnz[:3] = 0
    ids = rng.integers(0, d, (b, p)).astype(np.int32)
    vals = rng.random((b, p)).astype(np.float32)
    vals[rng.random((b, p)) < 0.2] = 0.0
    cells = np.stack([rng.permutation(5)[:n_probe] for _ in range(b)])
    cells[3:10] = [3, 0, 3][:n_probe]
    cells = cells.astype(np.int32)
    want = _naive_routed(ids, vals, nnz, means_t, cells, starts, sizes, 5)
    t = torch.from_numpy
    ops.reset_counts()
    got = ops.routed_scan(t(ids), t(vals), t(nnz), t(means_t), t(cells),
                          t(starts), t(sizes), 5)
    assert ops.PLAIN["routed_scan"] == 1 and ops.LAUNCHES["routed_scan"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0][:3].numpy() == starts[cells[:3, 0]]).all()
    assert (got[1][:3].numpy() == 0).all()
    tied = got[0][3:10].numpy()
    assert ((tied >= starts[3]) & (tied < starts[3] + 3)).all()
    # Garbage past nnz changes nothing.
    past = np.arange(p)[None, :] >= nnz[:, None]
    d_vals = np.where(past, 0.7, vals).astype(np.float32)
    d_ids = np.where(past, d - 1, ids).astype(np.int32)
    again = ref.routed_scan(t(d_ids), t(d_vals), t(nnz), t(means_t),
                            t(cells), t(starts), t(sizes), 5)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# ---------------------------------------------------------------------------
# Routed assignments at near ties, on a larger corpus.
# ---------------------------------------------------------------------------

def test_routed_assignments_part_from_repro_only_at_near_ties(tmp_path):
    """On ``pubmed8m.reduced()``'s corpus (20,000 documents, vocab 8,192,
    nt_mean 60, 200 topics) and a two-level model of K 200, K_c 14 that
    the port fits (mivi, 4 iterations, no EstParams) and ``repro`` loads
    from the port's save: the documents where the port's routed classify
    parts from ``repro``'s at n_probe 1, 2 and K_c (the flat classify).
    ``repro``'s scan is FMA-contracted and the port's is not, so a
    parting is allowed only at a near tie: the two winners' similarities
    within 1e-5.  None parted when this test was written."""
    spec = CorpusSpec(n_docs=20_000, vocab=8_192, nt_mean=60.0,
                      n_topics=200, seed=0)
    docs, df, _, _ = make_corpus(spec)
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    k_c = 14
    tm = fit(tdocs, ClusterConfig(k=200, coarse_k=k_c, n_probe=1,
                                  algo="mivi", params=None, max_iter=4,
                                  batch_size=4096, seed=0, device="cpu"),
             df=tdocs.df)
    tm.save(str(tmp_path / "port"))
    jm = jcluster.load_model(str(tmp_path / "port"))
    parted, gap = {}, {}        # by n_probe: documents parted, max |Δsim|
    for n_probe in (1, 2, k_c):
        a, s = classify_docs_routed(tm, tdocs, n_probe=n_probe,
                                    batch_size=4096)
        ja, js = (np.asarray(x) for x in jcluster.classify_docs_routed(
            jm, docs, n_probe=n_probe, batch_size=4096))
        part = a.numpy() != ja
        parted[n_probe] = int(part.sum())
        gap[n_probe] = float(np.abs(s.numpy() - js).max())
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=1e-5)
        assert (np.abs(s.numpy()[part] - js[part]) <= 1e-5).all(), parted
    print(f"parted assignments by n_probe {parted}; largest sim "
          f"difference {gap}")
