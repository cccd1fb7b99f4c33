"""The port's serving plane (``repro_torch.serve``) on the CPU, against
``repro.serve`` and against its own direct path.

Each test of ``tests/test_serving.py`` has a counterpart here, on
``device="cpu"`` (the plain versions, eagerly; on the card the same
servable replays one CUDA graph per bucket, ``tests/test_torch_cuda.py``):
bucket selection, dead-row padding, the pad-width lock, server results
equal to ``ClusterEngine.classify`` bit for bit, concurrent clients,
captures (none on the CPU), hot-swap atomicity with a batch pinned in
flight and under traffic, admission control, unload, the registry's
errors, the store refit against the resident refit bit for bit at two
chunkings, and the lazy LM import.  Beside them: a ``repro`` model carried
across with ``convert.model_from_numpy``, served by both packages'
servers (identical assignments, sims within 1e-5), and both engines'
refits (identical assignments and ρ bit for bit, means within 1e-6).

Every future waits with a timeout, and every server is closed by a
fixture, so a hang fails its test instead of the suite.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster as jcluster  # noqa: E402
from repro.data import CorpusSpec, make_corpus  # noqa: E402
from repro.serve import ClusterEngine as JEngine  # noqa: E402
from repro.serve import ClusterServer as JServer  # noqa: E402

from repro_torch.cluster import (ClusterConfig, ClusterEngine,  # noqa: E402
                                 classify_docs, fit)
from repro_torch.convert import docs_from_numpy, model_from_numpy  # noqa: E402
from repro_torch.serve import (ClusterServer, ModelRegistry,  # noqa: E402
                               ServableClusterModel, ServerClosed)
from repro_torch.sparse import DocStore  # noqa: E402

T = 60          # seconds any one wait may take


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (small tensors;
    the suite's workers would oversubscribe the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    """(docs numpy, docs on the port, model A, model B): two same-geometry
    port models with different means (different seeds and depths), on
    ``tests/test_serving.py``'s corpus (rows of 45 slots)."""
    docs, df, _, _ = make_corpus(
        CorpusSpec(n_docs=420, vocab=256, nt_mean=15, n_topics=8, seed=3))
    tdocs = docs_from_numpy(docs.ids, docs.vals, docs.nnz, docs.dim, df,
                            device="cpu")
    model_a = fit(tdocs, ClusterConfig(k=8, max_iter=8, batch_size=420,
                                       seed=1, device="cpu"))
    model_b = fit(tdocs, ClusterConfig(k=8, max_iter=2, batch_size=420,
                                       seed=7, device="cpu"))
    return docs, tdocs, model_a, model_b


@pytest.fixture(scope="module")
def carried(served):
    """``repro``'s fitted model (seed 1) and the same model in the port."""
    docs, tdocs, _, _ = served
    jm = jcluster.fit(docs, jcluster.ClusterConfig(k=8, max_iter=8,
                                                   batch_size=420, seed=1))
    ix = jm.index
    tm = model_from_numpy(ix.means_t, ix.moving, ix.params.t_th,
                          ix.params.v_th, labels=jm.labels,
                          rho_self=jm.rho_self, device="cpu")
    return jm, tm


@pytest.fixture
def make_server():
    """ClusterServer(device="cpu", ...) factory; closes every server it
    made when the test ends, passed or failed."""
    made = []

    def make(**kw):
        srv = ClusterServer(device="cpu", **kw)
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.close()


def _rows(docs, lo=None, hi=None):
    ids = np.asarray(docs.ids)[lo:hi]
    vals = np.asarray(docs.vals)[lo:hi]
    nnz = np.asarray(docs.nnz)[lo:hi]
    return ids, vals, nnz


def _direct(model, tdocs):
    """(assign, sims) numpy of the direct classify path."""
    a, s = ClusterEngine.from_model(model, device="cpu").classify(tdocs)
    return a.numpy(), s.numpy()


def _join(threads):
    for t in threads:
        t.join(T)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# Bucket selection, padding, the pad-width lock.
# ---------------------------------------------------------------------------

def test_bucket_selection_smallest_geq(served):
    _, _, model, _ = served
    sv = model.servable(batch_sizes=(64, 8, 16), device="cpu")
    assert sv.sorted_batch_sizes == (8, 16, 64)
    assert sv.max_batch_size == 64
    for n, want in [(1, 8), (8, 8), (9, 16), (16, 16), (17, 64), (64, 64)]:
        assert sv.get_padded_batch_size(n) == want
    with pytest.raises(ValueError, match="largest bucket"):
        sv.get_padded_batch_size(65)
    with pytest.raises(ValueError):
        sv.get_padded_batch_size(0)
    with pytest.raises(ValueError):
        ServableClusterModel(model, batch_sizes=(), device="cpu")


def test_pre_process_pads_with_dead_rows(served):
    docs, tdocs, model, _ = served
    sv = model.servable(batch_sizes=(8, 32), device="cpu")
    batch = sv.pre_process([_rows(docs, 0, 5), _rows(docs, 5, 14)])
    assert (batch.n_rows, batch.bucket) == (14, 32)
    assert batch.occupancy == pytest.approx(14 / 32)
    assert (batch.nnz[14:] == 0).all() and (batch.vals[14:] == 0).all()
    a, s = sv.post_process(sv.device_compute(batch), batch.n_rows)
    assert a.shape == s.shape == (14,)
    want_a, want_s = _direct(model, tdocs)
    np.testing.assert_array_equal(a, want_a[:14])
    np.testing.assert_array_equal(s, want_s[:14])


def test_pad_width_lock_widens_and_rejects(served):
    docs, _, model, _ = served
    p = np.asarray(docs.ids).shape[1]
    sv = model.servable(pad_width=p, device="cpu")
    ids, vals, nnz = _rows(docs, 0, 4)
    narrow = (ids[:, :10], vals[:, :10], np.minimum(nnz, 10))
    batch = sv.pre_process([narrow])                 # narrower rows widen
    assert batch.ids.shape[1] == p
    wide = ServableClusterModel(model, pad_width=4, device="cpu")
    assert nnz.max() > 4
    with pytest.raises(ValueError, match="pad_width"):
        wide.pre_process([(ids, vals, nnz)])
    lazy = model.servable(device="cpu")              # locks on first use
    assert lazy.pad_width is None
    lazy.pre_process([narrow])
    assert lazy.pad_width == 10


# ---------------------------------------------------------------------------
# Server results equal the direct path bit for bit.
# ---------------------------------------------------------------------------

def test_server_classify_parity_bit_identical(served, make_server):
    docs, tdocs, model, _ = served
    a_ref, s_ref = _direct(model, tdocs)
    srv = make_server(max_live_batches=2)
    srv.load("m", model, batch_sizes=(16, 64, 128))
    # 420 rows > the largest bucket (128): one future's parts, put back
    # together in request order.
    a, s = srv.classify("m", _rows(docs), timeout=T)
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(s, s_ref)
    for lo, hi in [(0, 1), (3, 20), (17, 130), (100, 101)]:
        a, s = srv.classify("m", _rows(docs, lo, hi), timeout=T)
        np.testing.assert_array_equal(a, a_ref[lo:hi])
        np.testing.assert_array_equal(s, s_ref[lo:hi])


def test_server_concurrent_clients_parity_and_occupancy(served,
                                                        make_server):
    docs, tdocs, model, _ = served
    a_ref, _ = _direct(model, tdocs)
    results = {}
    srv = make_server(max_live_batches=3, batch_timeout_s=0.005)
    srv.load("m", model)

    def client(i):
        lo = (i * 31) % 300
        hi = lo + 1 + (i % 70)
        results[i] = (lo, hi, srv.classify("m", _rows(docs, lo, hi),
                                           timeout=T))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    _join(threads)
    stats = srv.stats("m")
    assert len(results) == 16
    assert all((r[2][0] == a_ref[r[0]:r[1]]).all() for r in results.values())
    assert stats["n_failures"] == 0
    assert stats["n_requests"] == 16
    assert stats["peak_live_batches"] <= 3
    for row in stats["occupancy"].values():
        assert 0.0 < row["mean_occupancy"] <= 1.0


def test_capture_counts_stay_zero_on_the_cpu(served, make_server):
    """``repro``'s steady state is one compile per bucket; the port's is
    one CUDA graph capture per bucket on the card, and on the CPU, which
    runs eagerly, none: the counts stay 0 however much traffic runs."""
    docs, _, model, _ = served
    srv = make_server()
    srv.load("m", model, batch_sizes=(32,))
    for _ in range(5):
        srv.classify("m", _rows(docs, 0, 20), timeout=T)
    stats = srv.stats("m")
    assert stats["capture_counts"] == {"32": 0}
    assert stats["replay_counts"] == {"32": 0}


# ---------------------------------------------------------------------------
# Hot-swap atomicity and zero downtime.
# ---------------------------------------------------------------------------

class _SlowPost(ServableClusterModel):
    """Servable whose post-processing blocks until released: pins a batch
    in flight so a test can interleave a swap deterministically."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.entered = threading.Event()
        self.release = threading.Event()

    def post_process(self, out, n_rows):
        self.entered.set()
        assert self.release.wait(T), "test never released the slow batch"
        return super().post_process(out, n_rows)


def test_hot_swap_in_flight_completes_on_old_index(served, make_server):
    docs, tdocs, model_a, model_b = served
    a_old, _ = _direct(model_a, tdocs)
    a_new, _ = _direct(model_b, tdocs)
    assert (a_old != a_new).any(), "the two models must disagree somewhere"
    slow_a = _SlowPost(model_a, device="cpu")
    srv = make_server(max_live_batches=2, n_post_workers=2)
    srv.load("m", slow_a)
    fut1 = srv.submit("m", _rows(docs, 0, 50))
    assert slow_a.entered.wait(T)               # batch 1 is in flight
    try:
        old = srv.swap("m", model_b)            # atomic re-route
        assert old is slow_a
        # New traffic completes on the NEW index while the old batch is
        # still pinned in post-processing.
        a2, _ = srv.submit("m", _rows(docs, 0, 50)).result(timeout=T)
        np.testing.assert_array_equal(a2, a_new[:50])
        assert not fut1.done()
    finally:
        slow_a.release.set()
    a1, _ = fut1.result(timeout=T)
    np.testing.assert_array_equal(a1, a_old[:50])   # pre-swap index
    assert srv.stats("m")["n_failures"] == 0


def test_hot_swap_captures_nothing_on_the_cpu(served, make_server):
    """``repro``'s same-geometry swap costs zero recompiles; the port's
    captures one graph per bucket of the new servable on the card before
    it is published, and nothing on the CPU."""
    docs, tdocs, model_a, model_b = served
    srv = make_server()
    old = srv.load("m", model_a, batch_sizes=(64,))
    srv.classify("m", _rows(docs, 0, 40), timeout=T)
    assert srv.swap("m", model_b, batch_sizes=(64,)) is old
    a, _ = srv.classify("m", _rows(docs, 0, 40), timeout=T)
    np.testing.assert_array_equal(a, _direct(model_b, tdocs)[0][:40])
    assert old.capture_counts() == {64: 0}
    assert srv.registry.get("m").capture_counts() == {64: 0}
    assert srv.registry.get("m").pad_width == old.pad_width


def test_swap_during_traffic_no_torn_results(served, make_server):
    """Every response under a mid-stream swap equals full-A or full-B —
    never a mix (the registry read is one atomic reference)."""
    docs, tdocs, model_a, model_b = served
    a_old, _ = _direct(model_a, tdocs)
    a_new, _ = _direct(model_b, tdocs)
    failures, torn, done = [], [], []
    srv = make_server(max_live_batches=2, batch_timeout_s=0.001)
    srv.load("m", model_a)

    def client(i):
        lo = (i * 13) % 350
        hi = lo + 1 + (i % 60)
        try:
            a, _ = srv.classify("m", _rows(docs, lo, hi), timeout=T)
        except Exception as e:              # a hot-swap must fail no request
            failures.append(e)
            return
        done.append(i)
        if not ((a == a_old[lo:hi]).all() or (a == a_new[lo:hi]).all()):
            torn.append(i)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(24)]
    for t in threads[:12]:
        t.start()
    srv.swap("m", model_b)
    for t in threads[12:]:
        t.start()
    _join(threads)
    assert not failures and not torn and len(done) == 24


# ---------------------------------------------------------------------------
# Admission control, unload, the registry.
# ---------------------------------------------------------------------------

def test_admission_control_backpressure(served, make_server):
    docs, _, model, _ = served
    # 5-row requests against an 8-row bucket: no two coalesce, so every
    # request is its own batch and the single live slot throttles them.
    slow = _SlowPost(model, batch_sizes=(8,), device="cpu")
    srv = make_server(max_live_batches=1, queue_depth=1,
                      batch_timeout_s=0.0, n_post_workers=1)
    srv.load("m", slow)
    futs = [srv.submit("m", _rows(docs, 0, 5))]
    try:
        assert slow.entered.wait(T)             # batch 1 holds the one slot
        # The batcher can absorb at most one assembled-but-slotless batch
        # plus one carried request; after that the depth-1 queue stays full
        # and non-blocking admission must reject.
        rejected = False
        for _ in range(20):
            try:
                futs.append(srv.submit("m", _rows(docs, 0, 5), block=False))
            except ServerClosed as e:
                assert "queue full" in str(e)
                rejected = True
                break
            time.sleep(0.02)
        assert rejected, "full queue never backpressured a submit"
        assert srv.stats("m")["live_batches"] == 1
    finally:
        slow.release.set()
    for f in futs:                              # the backlog drains
        f.result(timeout=T)
    stats = srv.stats("m")
    assert stats["peak_live_batches"] == 1
    assert stats["n_failures"] == 0


class _SlowPre(ServableClusterModel):
    """Servable whose pre-processing blocks: pins the BATCHING thread so
    later requests provably sit in the queue when the model unloads."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.entered = threading.Event()
        self.release = threading.Event()

    def pre_process(self, rows):
        self.entered.set()
        assert self.release.wait(T), "test never released the slow batch"
        return super().pre_process(rows)


def test_unload_fails_queued_requests_and_close_is_idempotent(served,
                                                              make_server):
    docs, _, model, _ = served
    slow = _SlowPre(model, device="cpu")
    srv = make_server(batch_timeout_s=0.0)
    try:
        srv.load("m", slow)
        batcher = srv._batchers["m"]
        inflight = srv.submit("m", _rows(docs, 0, 4))
        assert slow.entered.wait(T)             # batching thread is pinned
        queued = [srv.submit("m", _rows(docs, 0, 4)) for _ in range(3)]
        un = threading.Thread(target=srv.unload, args=("m",))
        un.start()
        assert batcher._stopped.wait(T)         # unload reached the batcher
        slow.release.set()                      # let the pinned batch go
        _join([un])
        inflight.result(timeout=T)              # in-flight batch completed
        for f in queued:                        # never-batched ones fail
            with pytest.raises(ServerClosed, match="unloaded"):
                f.result(timeout=T)
        with pytest.raises(KeyError, match="no model"):
            srv.classify("m", _rows(docs, 0, 4), timeout=T)
    finally:
        slow.release.set()
        srv.close()
    srv.close()                                 # idempotent


def test_registry_errors_name_loaded_models(served):
    _, _, model, _ = served
    reg = ModelRegistry()
    sv = model.servable(device="cpu")
    reg.load("alpha", sv)
    with pytest.raises(ValueError, match="already loaded"):
        reg.load("alpha", sv)
    with pytest.raises(KeyError, match="alpha"):
        reg.get("beta")
    with pytest.raises(KeyError):
        reg.swap("beta", sv)
    assert reg.names() == ["alpha"] and "alpha" in reg
    assert reg.unload("alpha") is sv
    assert reg.names() == []


# ---------------------------------------------------------------------------
# Refit: the store refit equals the resident one bit for bit.
# ---------------------------------------------------------------------------

def _refit(model, docs, n_iter):
    eng = ClusterEngine.from_model(model, device="cpu", batch_size=200)
    a, r = eng.refit(docs, n_iter=n_iter)
    return eng, a, r


@pytest.mark.parametrize("chunk", [64, 128])
def test_refit_streams_docstore_parity(served, chunk):
    """Two rounds over stores of 7 and 4 chunks (ragged tails): the
    assignment, ρ and means of the resident refit, bit for bit."""
    _, tdocs, model, _ = served
    e_res, a_res, r_res = _refit(model, tdocs, 2)
    store = DocStore.from_docs(tdocs, chunk_size=chunk)
    assert store.n_chunks > 1 and store.n_rows > store.n_docs
    e_str, a_str, r_str = _refit(model, store, 2)
    assert torch.equal(a_res, a_str) and torch.equal(r_res, r_str)
    assert torch.equal(e_res.index.means_t, e_str.index.means_t)


def test_refit_one_chunk_store_bitwise(served):
    _, tdocs, model, _ = served
    e_res, a_res, r_res = _refit(model, tdocs, 1)
    e_str, a_str, r_str = _refit(model, DocStore.from_docs(tdocs), 1)
    assert torch.equal(a_res, a_str) and torch.equal(r_res, r_str)
    assert torch.equal(e_res.index.means_t, e_str.index.means_t)
    # The artifact carries the rebuilt index and the refit's labels and
    # ρ; the model it came from keeps its own index.
    got = e_res.to_model()
    assert torch.equal(got.labels, a_res) and torch.equal(got.rho_self, r_res)
    assert got.index is e_res.index and model.index is not e_res.index


# ---------------------------------------------------------------------------
# Against repro.
# ---------------------------------------------------------------------------

def test_server_matches_repro_server(served, carried, make_server):
    """``repro``'s model in both packages' servers: identical assignments,
    sims within 1e-5 (float32 sums in another order)."""
    docs, _, _, _ = served
    jm, tm = carried
    srv = make_server(max_live_batches=2)
    srv.load("m", tm, batch_sizes=(16, 64, 128))
    with JServer(max_live_batches=2) as jsrv:
        jsrv.load("m", jm, batch_sizes=(16, 64, 128))
        for lo, hi in [(0, 420), (3, 20), (17, 130), (100, 101)]:
            wa, ws = jsrv.classify("m", _rows(docs, lo, hi), timeout=T)
            a, s = srv.classify("m", _rows(docs, lo, hi), timeout=T)
            np.testing.assert_array_equal(a, wa)
            np.testing.assert_allclose(s, ws, rtol=1e-5, atol=1e-5)


def test_refit_matches_repro_refit(served, carried):
    """One and two refit rounds from ``repro``'s model on rows of 45
    slots: identical assignments and ρ bit for bit (ρ sums in ``repro``'s
    windowed order), means within 1e-6 as the update step's tests hold
    them."""
    docs, tdocs, _, _ = served
    jm, tm = carried
    for n_iter in (1, 2):
        je = JEngine.from_model(jm)
        wa, wr = je.refit(docs, n_iter=n_iter)
        te = ClusterEngine.from_model(tm, device="cpu")
        a, r = te.refit(tdocs, n_iter=n_iter)
        np.testing.assert_array_equal(a.numpy(), wa)
        np.testing.assert_array_equal(r.numpy(), wr)
        np.testing.assert_allclose(te.index.means_t.numpy(),
                                   np.asarray(je.index.means_t),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The engine's front door.
# ---------------------------------------------------------------------------

def test_engine_classify_serve_and_guards(served, monkeypatch):
    docs, tdocs, model, _ = served
    eng = ClusterEngine.from_model(model, device="cpu", batch_size=100)
    a, s = eng.classify(tdocs)
    want_a, want_s = classify_docs(model.index, tdocs)
    assert torch.equal(a, want_a) and torch.equal(s, want_s)
    sa, ss = eng.classify(DocStore.from_docs(tdocs, chunk_size=96))
    assert torch.equal(sa, a) and torch.equal(ss, s)
    with pytest.raises(ValueError, match="two-level"):
        eng.classify(tdocs, n_probe=2)
    with pytest.raises(ValueError, match="batch_size"):
        ClusterEngine.from_model(model, device="cpu", batch_size=0)
    with pytest.raises(ValueError, match="non-empty"):
        eng.refit(tdocs.slice_rows(0, 0))
    srv = eng.serve(name="news", max_live_batches=2)
    try:
        got = srv.classify("news", _rows(docs, 0, 30), timeout=T)
        np.testing.assert_array_equal(got[0], a[:30].numpy())
        assert srv.registry.names() == ["news"]
    finally:
        srv.close()
    # The default device is the card: without one, every entry point
    # raises instead of falling back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ClusterEngine.from_model(model),
                 lambda: ServableClusterModel(model),
                 lambda: ClusterServer()):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            make()


# ---------------------------------------------------------------------------
# Lazy LM split: repro_torch.serve must not import repro_torch.models.
# ---------------------------------------------------------------------------

def test_import_serve_does_not_import_models():
    code = (
        "import sys\n"
        "import repro_torch.serve\n"
        "assert 'repro_torch.models' not in sys.modules, 'models imported'\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "repro_torch.serve.ServeLoop              # lazy surface still works\n"
        "assert 'repro_torch.models' in sys.modules\n"
        "from repro_torch.cluster import ClusterEngine\n"
        "assert ClusterEngine is repro_torch.serve.ClusterEngine\n"
    )
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
