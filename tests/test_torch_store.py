"""The port's out-of-core data plane against ``repro`` and against its own
resident fit, on the CPU.

* the checkpoint store writes ``repro``'s format (leaf order, treedef,
  manifest) and each package restores the other's checkpoints;
* ``DocStoreBuilder`` writes the same bytes as ``repro``'s, and a store
  either package wrote opens in the other;
* the prefetcher's order, error propagation and abandoned consumer;
* ``ops.segment_update(init=)`` against the plain version, chunk after
  chunk equal to one call over the whole corpus, bit for bit;
* a one-chunk and a >= 4-chunk store fit equal the port's resident fit bit
  for bit (labels, ρ_self, means, history but ``elapsed_s``), in all nine
  modes, and ``repro``'s ``streaming_fit(backend="reference")`` from
  ``repro``'s seed rows (labels, integer history, objective within 1e-5);
* minibatch: ``repro``'s labels after every pass, means within 1e-6;
* mid-epoch resume (full and minibatch) gives the uninterrupted fit's
  labels, also from a checkpoint that ``repro`` wrote.
"""
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import store as jckpt  # noqa: E402
from repro.core.lloyd import streaming_fit as jstreaming_fit  # noqa: E402
from repro.core.update import seed_rows as jseed_rows  # noqa: E402
from repro.data import CorpusSpec as JSpec  # noqa: E402
from repro.data import make_corpus as jmake_corpus  # noqa: E402
from repro.sparse import DocStore as JDocStore  # noqa: E402
from repro.sparse import DocStoreBuilder as JBuilder  # noqa: E402

from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.convert import docs_from_numpy  # noqa: E402
from repro_torch.core.assignment import ALGORITHMS  # noqa: E402
from repro_torch.core.lloyd import lloyd_fit, streaming_fit  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.sparse import (ChunkPrefetcher, DocStore,  # noqa: E402
                                DocStoreBuilder, SparseDocs)

K_TINY, SEED_TINY = 8, 1


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
def tiny():
    """The 400-document corpus of tests/test_store.py, in both packages,
    and repro's seed rows for k 8, seed 1."""
    docs, df, _, _ = jmake_corpus(JSpec(n_docs=400, vocab=512, nt_mean=20,
                                        n_topics=8, seed=0))
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    rows = torch.from_numpy(np.array(jseed_rows(400, K_TINY,
                                                  seed=SEED_TINY)))
    return docs, df, tdocs, rows


@pytest.fixture(scope="module")
def small(small_corpus):
    """The 1500×1024 corpus of tests/test_torch_fit.py in the port, and
    repro's seed rows for k 16, seed 0."""
    docs, df, _, _ = small_corpus
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    rows = torch.from_numpy(np.array(jseed_rows(1500, 16, seed=0)))
    return tdocs, rows


def _fit_kw(rows, **kw):
    return dict(seed_rows=rows, device="cpu", keep_trajectory=True, **kw)


def assert_same_fit(a, b):
    """Bit for bit: iterations, the assignment after each, ρ_self, the
    means and every history field but elapsed_s."""
    assert a.n_iter == b.n_iter and a.converged == b.converged
    for x, y in zip(a.trajectory, b.trajectory):
        assert torch.equal(x, y)
    for ha, hb in zip(a.history, b.history):
        ha, hb = dict(ha), dict(hb)
        ha.pop("elapsed_s")
        hb.pop("elapsed_s")
        assert ha == hb
    assert torch.equal(a.assign, b.assign)
    assert torch.equal(a.state.rho_self, b.state.rho_self)
    assert torch.equal(a.state.index.means_t, b.state.index.means_t)


# ---------------------------------------------------------------------------
# Checkpoint store format.
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(0)
    return {"zeta": rng.random((3, 4)).astype(np.float32),
            "alpha": np.arange(5, dtype=np.int32),
            "mid": np.asarray(7, np.int64),
            "flags": rng.random(6) > 0.5}


def test_checkpoint_format_matches_repro(tmp_path):
    tree = _tree()
    tp = tckpt.save_checkpoint(str(tmp_path / "t"), tree, step=3,
                               extra={"a": 1})
    jp = jckpt.save_checkpoint(str(tmp_path / "j"), tree, step=3,
                               extra={"a": 1})
    assert os.path.basename(tp) == os.path.basename(jp) == "step_00000003"
    for name in ("manifest.json", "extra.json"):
        with open(os.path.join(tp, name)) as f, \
                open(os.path.join(jp, name)) as g:
            assert json.load(f) == json.load(g)
    with np.load(os.path.join(tp, "payload.npz")) as a, \
            np.load(os.path.join(jp, "payload.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    tree = _tree()
    save = (tckpt if writer == "port" else jckpt).save_checkpoint
    restore = (jckpt if writer == "port" else tckpt).restore_checkpoint
    d = str(tmp_path / "c")
    for step in (1, 2, 5):
        save(d, tree, step=step, keep=2, extra={"step": step})
    assert tckpt.all_steps(d) == [2, 5] and tckpt.latest_step(d) == 5
    assert tckpt.load_extra(d) == {"step": 5}
    got, step = restore(d, {k: np.zeros_like(v) for k, v in tree.items()})
    assert step == 5
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(d, dict(tree, alpha=np.zeros(4)))
    with pytest.raises(FileNotFoundError):
        tckpt.load_extra(str(tmp_path / "none"))


def test_async_checkpointer(tmp_path):
    ck = tckpt.AsyncCheckpointer(str(tmp_path / "a"), keep=2)
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    ck.save(tree, step=1, extra={"s": 1})
    tree["x"] += 10                 # the snapshot was taken at save()
    ck.save(tree, step=2)
    ck.wait()
    got, _ = tckpt.restore_checkpoint(str(tmp_path / "a"),
                                      {"x": np.zeros(4)}, step=1)
    np.testing.assert_array_equal(got["x"], [0, 1, 2, 3])
    assert tckpt.load_extra(str(tmp_path / "a"), step=1) == {"s": 1}


# ---------------------------------------------------------------------------
# DocStore, builder, prefetcher.
# ---------------------------------------------------------------------------

def _raw_rows():
    rng = np.random.default_rng(3)
    n, d, p = 230, 64, 12
    ids = np.zeros((n, p), np.int32)
    vals = np.zeros((n, p), np.float32)
    for i in range(n):
        m = int(rng.integers(3, p))
        ids[i, :m] = np.sort(rng.choice(d, size=m, replace=False))
        vals[i, :m] = rng.integers(1, 5, size=m)
    return ids, vals, d, p


def test_builder_writes_repro_bytes(tmp_path):
    ids, vals, d, p = _raw_rows()
    out = {}
    for name, cls in (("port", DocStoreBuilder), ("repro", JBuilder)):
        b = cls(str(tmp_path / name), dim=d, chunk_size=64, pad_width=p)
        for s in range(0, len(ids), 37):                # uneven batches
            b.append(ids[s:s + 37], vals[s:s + 37])
        out[name] = b.finalize()
    files = sorted(os.listdir(out["port"].directory))
    assert files == sorted(os.listdir(out["repro"].directory))
    assert len([f for f in files if f.startswith("chunk_")]) == 4 * 3
    for f in files:
        with open(os.path.join(out["port"].directory, f), "rb") as a, \
                open(os.path.join(out["repro"].directory, f), "rb") as b:
            assert a.read() == b.read(), f


def test_stores_open_across_packages(tmp_path, tiny):
    docs, df, tdocs, _ = tiny
    jdir = JDocStore.from_docs(docs, chunk_size=150).save(
        str(tmp_path / "j")).directory
    tdir = DocStore.from_docs(tdocs, chunk_size=150).save(
        str(tmp_path / "t")).directory
    for d in (jdir, tdir):
        got = DocStore.open(d)
        assert (got.n_docs, got.n_chunks, got.n_rows) == (400, 3, 450)
        back = got.to_docs(device="cpu")
        assert torch.equal(back.ids, tdocs.ids)
        assert torch.equal(back.vals, tdocs.vals)
        assert torch.equal(back.nnz, tdocs.nnz)
        assert torch.equal(back.df, tdocs.df)
        j = JDocStore.open(d)
        for ci in range(3):
            for a, b in zip(j.host_chunk(ci), got.host_chunk(ci)):
                np.testing.assert_array_equal(np.asarray(a), b)
        assert got.chunk_valid(2).sum() == 100 == got.n_valid(2)
    disk = DocStore.open(tdir)
    for ci in range(disk.n_chunks):          # straight into given arrays
        out = [np.empty_like(np.asarray(a)) for a in disk.host_chunk(ci)]
        disk.read_chunk(ci, out)
        for a, b in zip(out, disk.host_chunk(ci)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not the chunk's"):
        disk.read_chunk(0, [np.empty((3, 3), np.int32)] * 3)
    pick = np.asarray([399, 0, 130, 130, 77])
    sel = disk.gather_rows(pick, device="cpu")
    assert torch.equal(sel.ids, tdocs.ids[pick])
    assert torch.equal(sel.vals, tdocs.vals[pick])


def test_store_df_counted_when_absent(tiny):
    _, _, tdocs, _ = tiny
    bare = SparseDocs(tdocs.ids, tdocs.vals, tdocs.nnz, tdocs.dim)
    store = DocStore.from_docs(bare, chunk_size=128)
    np.testing.assert_array_equal(store.df, tdocs.df.numpy())


def test_prefetcher_orders_and_propagates_errors(tiny):
    _, _, tdocs, _ = tiny
    store = DocStore.from_docs(tdocs, chunk_size=100)
    got = [(ci, d) for ci, d in ChunkPrefetcher(store, device="cpu")]
    assert [ci for ci, _ in got] == [0, 1, 2, 3]
    assert torch.equal(got[2][1].ids, tdocs.ids[200:300])
    assert [ci for ci, _ in ChunkPrefetcher(store, order=[2, 0],
                                            device="cpu")] == [2, 0]
    trip = list(ChunkPrefetcher(store, order=[1], device="cpu",
                                prepare=lambda ci, d: ci * 10))
    assert trip[0][0] == 1 and trip[0][2] == 10
    with pytest.raises(IndexError):
        list(ChunkPrefetcher(store, order=[0, 99], device="cpu"))


def test_prefetcher_abandoned_consumer_unblocks_producer(tiny):
    _, _, tdocs, _ = tiny
    store = DocStore.from_docs(tdocs, chunk_size=50)   # 8 chunks, depth 2
    before = threading.active_count()
    for _ in ChunkPrefetcher(store, device="cpu"):
        break
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# segment_update with init.
# ---------------------------------------------------------------------------

def test_segment_update_init_chunks_equal_one_call(tiny):
    _, _, tdocs, _ = tiny
    k = 13
    assign = torch.from_numpy(np.random.default_rng(4).integers(
        -1, k + 1, size=400).astype(np.int32))
    whole = ops.segment_update(assign, tdocs, k=k)
    lam = None
    ops.reset_counts()
    for s in range(0, 400, 96):                  # 5 chunks, ragged tail
        part = tdocs.slice_rows(s, 96)
        lam = ops.segment_update(assign[s:s + part.n_docs], part, k=k,
                                 init=lam)
    assert torch.equal(lam, whole)
    assert ops.PLAIN["segment_update"] == 1
    assert ops.PLAIN["segment_update_init"] == 4
    # the plain version with init adds in place onto it
    init = torch.randn((tdocs.dim, k), generator=torch.Generator()
                       .manual_seed(0))
    want = init + ref.segment_update(assign, tdocs.ids, tdocs.live_vals(),
                                     k, tdocs.dim)
    got = ops.segment_update(assign, tdocs, k=k, init=init.clone())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="init must be"):
        ops.segment_update(assign, tdocs, k=k, init=torch.zeros((3, k)))


# ---------------------------------------------------------------------------
# Streaming fit vs the resident fit, and vs repro.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_resident(small):
    tdocs, rows = small
    return lloyd_fit(tdocs, k=16, batch_size=750, **_fit_kw(rows))


@pytest.mark.parametrize("chunk", [None, 375, 400])
def test_store_fit_equals_resident_fit(small, small_resident, chunk):
    """One chunk, four even chunks, four chunks with a dead tail."""
    tdocs, rows = small
    want = small_resident
    store = DocStore.from_docs(tdocs, chunk_size=chunk)
    assert store.n_chunks == (1 if chunk is None else 4)
    got = streaming_fit(store, k=16, batch_size=750, **_fit_kw(rows))
    assert_same_fit(want, got)
    assert got.cursor is None and want.converged


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_store_fit_equals_resident_fit_every_mode(tiny, algo):
    _, df, tdocs, rows = tiny
    kw = _fit_kw(rows, k=K_TINY, algo=algo, batch_size=64, max_iter=8)
    want = lloyd_fit(tdocs, **kw)
    got = streaming_fit(DocStore.from_docs(tdocs, chunk_size=96), **kw)
    assert_same_fit(want, got)


@pytest.fixture(scope="module")
def repro_full(tiny):
    docs, df, _, _ = tiny
    store = JDocStore.from_docs(docs, chunk_size=100)
    return jstreaming_fit(store, k=K_TINY, max_iter=20, batch_size=100,
                          seed=SEED_TINY, df=df)


def test_store_fit_matches_repro_streaming(small, small_corpus):
    """Four chunks of the 1500-document corpus against ``repro``'s
    streaming fit over the same chunks, from ``repro``'s seed rows."""
    tdocs, rows = small
    docs, df, _, _ = small_corpus
    want = jstreaming_fit(JDocStore.from_docs(docs, chunk_size=375), k=16,
                          batch_size=375, seed=0, df=df)
    got = streaming_fit(DocStore.from_docs(tdocs, chunk_size=375), k=16,
                        batch_size=375, seed_rows=rows, device="cpu")
    np.testing.assert_array_equal(np.asarray(want.assign),
                                  got.assign.numpy())
    assert got.n_iter == want.n_iter and got.converged == want.converged
    for hw, hg in zip(want.history, got.history):
        for f in ("iteration", "mult", "n_changed", "n_moving", "t_th",
                  "v_th"):
            assert hw[f] == hg[f], f                # Mult < 2^24: exact
        assert hg["n_candidates"] == round(hw["cpr"] * 1500 * 16)
        assert hg["objective"] == pytest.approx(hw["objective"], rel=1e-5)
    assert got.objective == pytest.approx(want.objective, rel=1e-5)


def test_store_fit_mult_history_matches_repro(tiny, repro_full):
    """The 400-document corpus, k 8, batch 100, ``repro``'s seed rows:
    ρ_self sums in ``repro``'s order (rows of 58 slots), so Mult and |Z|
    equal ``repro``'s at every iteration, where a lane-by-lane ρ parted at
    iteration 3 (15,458 against 15,451); labels and ρ_self bit for bit."""
    _, _, tdocs, rows = tiny
    got = streaming_fit(DocStore.from_docs(tdocs, chunk_size=100), k=K_TINY,
                        max_iter=20, batch_size=100, seed_rows=rows,
                        device="cpu")
    want = repro_full
    assert got.n_iter == want.n_iter and got.converged == want.converged
    for hw, hg in zip(want.history, got.history):
        for f in ("iteration", "mult", "n_changed", "n_moving", "t_th",
                  "v_th"):
            assert hw[f] == hg[f], (f, hw["iteration"])
        assert hg["n_candidates"] == round(hw["cpr"] * 400 * K_TINY)
    np.testing.assert_array_equal(got.assign.numpy(),
                                  np.asarray(want.assign))
    np.testing.assert_array_equal(got.state.rho_self.numpy(),
                                  np.asarray(want.state.rho_self))


def test_minibatch_matches_repro_every_pass(tiny):
    docs, df, tdocs, rows = tiny
    jstore = JDocStore.from_docs(docs, chunk_size=100)
    got = streaming_fit(DocStore.from_docs(tdocs, chunk_size=100), k=K_TINY,
                        algo_mode="minibatch", max_iter=3, batch_size=100,
                        seed_rows=rows, device="cpu", keep_trajectory=True)
    assert got.n_iter == 3
    obj = [h["objective"] for h in got.history]
    assert all(h["mult"] == 0 for h in got.history)
    assert obj[-1] > obj[0]
    for r in range(1, 4):
        want = jstreaming_fit(jstore, k=K_TINY, algo_mode="minibatch",
                              max_iter=r, batch_size=100, seed=SEED_TINY)
        np.testing.assert_array_equal(np.asarray(want.assign),
                                      got.trajectory[r - 1].numpy())
        h = want.history[-1]
        assert h["n_changed"] == got.history[r - 1]["n_changed"]
        assert h["objective"] == pytest.approx(obj[r - 1], rel=1e-5)
    np.testing.assert_allclose(got.state.index.means_t.numpy(),
                               np.asarray(want.state.index.means_t),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints and resume.
# ---------------------------------------------------------------------------

def _rewind_to_mid_epoch(ckpt: str, n_chunks: int) -> int:
    """Delete every step after the last mid-epoch one; returns it."""
    steps = tckpt.all_steps(ckpt)
    mid = [s for s in steps if s % (n_chunks + 1) != 0]
    assert mid, "expected a surviving mid-epoch checkpoint"
    for s in steps:
        if s > mid[-1]:
            shutil.rmtree(os.path.join(ckpt, f"step_{s:08d}"))
    return mid[-1]


@pytest.mark.parametrize("algo_mode", ["full", "minibatch"])
def test_resume_from_mid_epoch_checkpoint(tiny, tmp_path, algo_mode):
    _, df, tdocs, rows = tiny
    store = DocStore.from_docs(tdocs, chunk_size=100)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(k=K_TINY, algo_mode=algo_mode, max_iter=12, batch_size=100,
              seed_rows=rows, device="cpu")
    full = streaming_fit(store, checkpoint_dir=ckpt, checkpoint_every=3,
                         **kw)
    step = _rewind_to_mid_epoch(ckpt, store.n_chunks)
    extra = tckpt.load_extra(ckpt, step=step)
    assert extra["format"] == "repro.cluster/stream-ckpt-v2"
    assert extra["algo_mode"] == algo_mode and extra["cursor"][1] == 3
    resumed = streaming_fit(store, checkpoint_dir=ckpt, resume=True, **kw)
    assert torch.equal(resumed.assign, full.assign)
    assert resumed.n_iter == full.n_iter
    for ha, hb in zip(full.history, resumed.history):
        assert {f: ha[f] for f in ha if f != "elapsed_s"} == \
            {f: hb[f] for f in hb if f != "elapsed_s"}
    with pytest.raises(ValueError, match="algo_mode"):
        streaming_fit(store, checkpoint_dir=ckpt, resume=True,
                      **dict(kw, algo_mode={"full": "minibatch",
                                            "minibatch": "full"}[algo_mode]))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        streaming_fit(store, resume=True, **kw)


def test_resume_a_checkpoint_repro_wrote(tiny, tmp_path, repro_full):
    docs, df, tdocs, rows = tiny
    ckpt = str(tmp_path / "ckpt")
    jstore = JDocStore.from_docs(docs, chunk_size=100)
    jstreaming_fit(jstore, k=K_TINY, max_iter=20, batch_size=100,
                   seed=SEED_TINY, df=df, checkpoint_dir=ckpt,
                   checkpoint_every=3)
    _rewind_to_mid_epoch(ckpt, jstore.n_chunks)
    got = streaming_fit(DocStore.from_docs(tdocs, chunk_size=100),
                        k=K_TINY, max_iter=20, batch_size=100,
                        device="cpu", checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(got.assign.numpy(),
                                  np.asarray(repro_full.assign))
    assert got.n_iter == repro_full.n_iter and got.converged


def test_resume_after_the_last_chunk_of_an_epoch(tiny, tmp_path):
    """A snapshot after the epoch's last chunk: the resumed epoch has no
    chunk left to assign, only its update."""
    _, _, tdocs, rows = tiny
    store = DocStore.from_docs(tdocs, chunk_size=100)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(k=K_TINY, max_iter=12, batch_size=100, seed_rows=rows,
              device="cpu")
    full = streaming_fit(store, checkpoint_dir=ckpt, checkpoint_every=1,
                         **kw)
    _rewind_to_mid_epoch(ckpt, store.n_chunks)
    assert tckpt.load_extra(ckpt)["cursor"][1] == store.n_chunks
    resumed = streaming_fit(store, checkpoint_dir=ckpt, resume=True, **kw)
    assert torch.equal(resumed.assign, full.assign)
    assert resumed.n_iter == full.n_iter
    assert list(ChunkPrefetcher(store, order=[], device="cpu")) == []


def test_unconverged_fit_reports_cursor(tiny):
    _, _, tdocs, rows = tiny
    got = streaming_fit(DocStore.from_docs(tdocs, chunk_size=100),
                        k=K_TINY, max_iter=2, batch_size=100,
                        seed_rows=rows, device="cpu")
    assert not got.converged and got.cursor == (3, 0)
    assert len(got.prefetch["wait_s"]) == 2
    # the fit's own pass times: EstParams at iterations 1-2
    assert [list(p) for p in got.passes] == [
        ["assignment pass", "index rebuild", "ρ pass", "bounds",
         "EstParams"]] * 2
    assert all(sec >= 0 for p in got.passes for sec in p.values())
