"""The port's mesh runtime (``repro_torch.distributed``,
``repro_torch.launch.mesh``) against ``repro``'s ``mesh_fit`` and the
port's ``lloyd_fit``, on the CPU with gloo.

Worlds of 2 and 4 ranks are spawned by ``run_local_world`` (a ``file://``
rendezvous in ``tmp_path``, one torch thread a rank, each world bounded by
a timeout); ``repro``'s answers come from this process, which has 8 host
devices (tests/conftest.py).  Corpus: 400 documents, vocab 512, K 18
(bound groups of 2, so the model split at K/2 = 9 cuts group 4 in two),
object chunks of 64 rows, from ``repro``'s seed rows.

* a world of one and (1, 2): each of the six mesh modes equals ``repro``'s
  ``mesh_fit`` on the same mesh and the port's ``lloyd_fit`` (EstParams for
  esicp only, the mesh's quirk) bit for bit: assignments, ρ_self, means,
  #changed, |Z|, t_th (and the bounds against ``lloyd_fit``);
* (2, 2) and ("pod", "data", "model") (2, 1, 2): labels and #changed equal
  ``repro``'s, means within 1e-6, objective within 1e-5 relative;
* ``make_assign_fn`` on (2, 2) equals ``classify_docs`` bit for bit; a
  DocStore input equals the resident fit; ``SphericalKMeans(mesh=)`` fits,
  predicts, saves and loads;
* a (2, 2) checkpoint (the port's, and ``repro``'s) resumed on (1, 2) ends
  with the uninterrupted fit's labels; the port's mesh checkpoint has
  ``repro``'s tree, shapes and dtypes and loads in ``repro``;
* the config refusals, ``StepWatchdog``, ``ShardedBatches``, a failing
  rank, and the packages' imports (no JAX).
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import (make_test_mesh,  # noqa: E402
                                     run_local_world)

N_DOCS, K, OBJ, MAX_ITER, SEED = 400, 18, 64, 8, 1
ALGOS = ("esicp", "mivi", "icp", "bounds", "sketch", "bounds-esicp")
WORLD_TIMEOUT = 120.0
PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (the suite's
    workers would otherwise oversubscribe the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# What a rank of a spawned world runs (module level, so it pickles).
# ---------------------------------------------------------------------------

def _port_docs(arrays):
    from repro_torch.convert import docs_from_numpy

    return docs_from_numpy(*arrays, device="cpu")


def _whole(mesh, state, history):
    """The gathered fit on every rank, as numpy (rank 0's is kept)."""
    from repro_torch.distributed.kmeans import gather_state

    means, moving, assign, rho, _, ub = gather_state(mesh, state)
    return {"assign": assign.numpy(), "rho": rho.numpy(),
            "means": means.numpy(), "ub": ub.numpy(), "history": history}


def _rank_jobs(shape, axes, arrays, rows, jobs, tmp):
    """One rank of a CPU world: the jobs named, each a tuple; returns
    {job: result} (fit results gathered on every rank)."""
    from repro_torch.cluster import SphericalKMeans, classify_docs, load_model
    from repro_torch.core.meanindex import build_mean_index
    from repro_torch.distributed.kmeans import (ShardGeometry,
                                                make_assign_fn, mesh_fit)
    from repro_torch.sparse import DocStore

    mesh = make_test_mesh(shape, axes, device="cpu")
    docs = _port_docs(arrays)
    out = {}
    for job in jobs:
        kind = job[0]
        kw = dict(max_iter=MAX_ITER, obj_chunk=OBJ, seed_rows=rows)
        if kind == "fit":
            algo, ckpt = job[1], job[2] if len(job) > 2 else None
            state, hist, _, _ = mesh_fit(
                docs, K, mesh, algo=algo, checkpoint_dir=ckpt,
                checkpoint_every=2, **kw)
            out[job] = _whole(mesh, state, hist)
            if kind == "fit" and algo == "esicp":
                # the mesh classify of this rank's rows against its block
                geo = ShardGeometry.of(mesh, N_DOCS, K, OBJ)
                fn = make_assign_fn(mesh, k=K, obj_chunk=48)
                mine = docs.slice_rows(geo.row0, geo.n_real)
                a, s = fn(mine, state.means_t)
                full = out[job]["means"]
                ref = classify_docs(build_mean_index(
                    torch.from_numpy(full), state.index.params), mine,
                    batch_size=128)
                out["assign_fn"] = (geo.row0, a.numpy(), s.numpy(),
                                    ref[0].numpy(), ref[1].numpy())
        elif kind == "store":
            store = DocStore.from_docs(docs, chunk_size=96)
            state, hist, _, _ = mesh_fit(store, K, mesh, algo=job[1], **kw)
            out[job] = _whole(mesh, state, hist)
        elif kind == "resume":
            state, hist, _, _ = mesh_fit(docs, K, mesh, algo="esicp",
                                         checkpoint_dir=job[1], resume=True,
                                         **kw)
            out[job] = _whole(mesh, state, hist)
        elif kind == "estimator":
            km = SphericalKMeans(K, mesh=mesh, device="cpu", chunk_size=OBJ,
                                 max_iter=MAX_ITER).fit(docs, seed_rows=rows)
            path = os.path.join(tmp, "model")
            if mesh.rank == 0:
                km.model_.save(path)
            torch.distributed.barrier()
            loaded = load_model(path, device="cpu")
            out[job] = (km.labels_.numpy(), km.predict(docs).numpy(),
                        loaded.predict(docs).numpy(), km.model_.strategy,
                        km.n_iter_)
    return out


def _world(shape, axes, arrays, rows, jobs, tmp):
    n = int(np.prod(shape))
    return run_local_world(_rank_jobs, n, args=(shape, axes, arrays, rows,
                                                jobs, str(tmp)),
                           timeout=WORLD_TIMEOUT, workdir=str(tmp))


def _raise_on_rank_one():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank one fails")
    return "fine"


def _sleep_forever():
    time.sleep(3600)


# ---------------------------------------------------------------------------
# repro's answers.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    from repro.core.update import seed_rows as jseed_rows
    from repro.data import CorpusSpec as JSpec
    from repro.data import make_corpus as jmake_corpus

    docs, df, _, _ = jmake_corpus(JSpec(n_docs=N_DOCS, vocab=512, nt_mean=20,
                                        n_topics=8, seed=0))
    arrays = (np.asarray(docs.ids), np.asarray(docs.vals),
              np.asarray(docs.nnz), docs.dim, np.asarray(df))
    rows = np.asarray(jseed_rows(N_DOCS, K, seed=SEED))
    return docs, arrays, rows


def _repro_fit(docs, shape, axes, algo, ckpt=None):
    from repro.distributed.kmeans import mesh_fit as jmesh_fit
    from repro.launch.mesh import make_test_mesh as jmesh

    state, hist, _, params = jmesh_fit(
        docs, K, jmesh(shape, axes), algo=algo, max_iter=MAX_ITER,
        obj_chunk=OBJ, seed=SEED, checkpoint_dir=ckpt, checkpoint_every=2)
    return {"assign": np.asarray(state.assign)[:N_DOCS],
            "rho": np.asarray(state.rho_self)[:N_DOCS],
            "means": np.asarray(state.means_t), "history": hist,
            "t_th": int(params.t_th)}


@pytest.fixture(scope="module")
def repro_fits(corpus, tmp_path_factory):
    """repro's mesh fits, computed on first use."""
    docs = corpus[0]
    cache = {}
    ckpt = tmp_path_factory.mktemp("repro_ckpt")

    def get(shape, axes, algo):
        key = (shape, axes, algo)
        if key not in cache:
            keep = (str(ckpt) if (shape, algo) == ((2, 2), "esicp")
                    else None)
            cache[key] = _repro_fit(docs, shape, axes, algo, keep)
        return cache[key]

    get.ckpt = ckpt
    return get


@pytest.fixture(scope="module")
def lloyd_fits(corpus):
    """The port's lloyd_fit per mode, EstParams for esicp only (the mesh
    keeps the trivial thresholds in the other modes)."""
    from repro_torch.core.lloyd import lloyd_fit

    tdocs = _port_docs(corpus[1])
    out = {}
    for algo in ALGOS:
        res = lloyd_fit(tdocs, k=K, algo=algo, max_iter=MAX_ITER,
                        batch_size=OBJ, seed_rows=torch.tensor(corpus[2]),
                        device="cpu",
                        params="auto" if algo == "esicp" else None)
        out[algo] = {"assign": res.assign.numpy(),
                     "rho": res.state.rho_self.numpy(),
                     "means": res.state.index.means_t.numpy(),
                     "ub": res.state.ub.numpy(), "history": res.history}
    return out


def _strip(history):
    """Every history field but elapsed_s."""
    return [{f: v for f, v in h.items() if f != "elapsed_s"}
            for h in history]


def _same_as_lloyd(got, want):
    for name in ("assign", "rho", "means", "ub"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ints = ("iteration", "n_changed", "n_candidates", "t_th")
    assert ([{f: h[f] for f in ints} for h in got["history"]]
            == [{f: h[f] for f in ints} for h in want["history"]])


def _same_as_repro(got, want, *, exact: bool):
    np.testing.assert_array_equal(got["assign"], want["assign"])
    hg, hw = got["history"], want["history"]
    assert [h["n_changed"] for h in hg] == [int(h["n_changed"]) for h in hw]
    if exact:
        for name in ("rho", "means"):
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
        assert [h["t_th"] for h in hg] == [h["t_th"] for h in hw]
        assert [h["n_candidates"] for h in hg] == [
            round(h["cpr"] * N_DOCS * K) for h in hw]
    else:
        np.testing.assert_allclose(got["means"], want["means"], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose([h["objective"] for h in hg],
                               [h["objective"] for h in hw], rtol=1e-5)


# ---------------------------------------------------------------------------
# Worlds.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_22(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world_22")
    jobs = [("fit", "esicp", str(tmp / "ckpt")), ("fit", "bounds-esicp"),
            ("store", "esicp"), ("estimator",)]
    got = _world((2, 2), ("data", "model"), corpus[1], corpus[2], jobs, tmp)
    return got, jobs, tmp


@pytest.fixture(scope="module")
def world_12(corpus, world_22, repro_fits, tmp_path_factory):
    """(1, 2): the six modes, and the (2, 2) fits' iteration-2 checkpoints
    (the port's and repro's) resumed."""
    tmp = tmp_path_factory.mktemp("world_12")
    repro_fits((2, 2), ("data", "model"), "esicp")      # writes its ckpt
    resumes = {}
    for who, src in (("port", world_22[2] / "ckpt"),
                     ("repro", repro_fits.ckpt)):
        dst = tmp / f"resume_{who}"
        shutil.copytree(src / "step_00000002", dst / "step_00000002")
        resumes[who] = str(dst)
    jobs = [("fit", a) for a in ALGOS] + [("resume", d)
                                          for d in resumes.values()]
    got = _world((1, 2), ("data", "model"), corpus[1], corpus[2], jobs, tmp)
    return got, resumes


@pytest.fixture(scope="module")
def world_212(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world_212")
    jobs = [("fit", "icp"), ("fit", "bounds-esicp")]
    return _world((2, 1, 2), ("pod", "data", "model"), corpus[1], corpus[2],
                  jobs, tmp)


@pytest.mark.parametrize("algo", ALGOS)
def test_world_of_one_equals_repro_and_lloyd(algo, corpus, repro_fits,
                                             lloyd_fits):
    from repro_torch.distributed.kmeans import mesh_fit

    mesh = make_test_mesh((1, 1), device="cpu")
    state, hist, _, _ = mesh_fit(_port_docs(corpus[1]), K, mesh, algo=algo,
                                 max_iter=MAX_ITER, obj_chunk=OBJ,
                                 seed_rows=corpus[2])
    got = {"assign": state.assign[:N_DOCS].numpy(),
           "rho": state.rho_self[:N_DOCS].numpy(),
           "means": state.means_t.numpy(), "ub": state.ub[:N_DOCS].numpy(),
           "history": hist}
    _same_as_lloyd(got, lloyd_fits[algo])
    _same_as_repro(got, repro_fits((1, 1), ("data", "model"), algo),
                   exact=True)


def test_lambda_in_spans_equals_one_launch(corpus, lloyd_fits,
                                           monkeypatch):
    """λ summed span after span (the accumulating launch from the
    second span on) is the one-launch λ bit for bit."""
    from repro_torch.distributed import kmeans
    from repro_torch.kernels import ops

    monkeypatch.setattr(kmeans, "LAMBDA_SPAN", 96)
    ops.reset_counts()
    state, hist, _, _ = kmeans.mesh_fit(
        _port_docs(corpus[1]), K, make_test_mesh((1, 1), device="cpu"),
        max_iter=MAX_ITER, obj_chunk=OBJ, seed_rows=corpus[2])
    assert ops.PLAIN["segment_update_init"] == 4 * len(hist)
    _same_as_lloyd({"assign": state.assign[:N_DOCS].numpy(),
                    "rho": state.rho_self[:N_DOCS].numpy(),
                    "means": state.means_t.numpy(),
                    "ub": state.ub[:N_DOCS].numpy(), "history": hist},
                   lloyd_fits["esicp"])


def test_lambda_dtype_bfloat16_equals_repros(corpus):
    """The compressed λ reduction (``lambda_dtype``): λ rounded to
    bfloat16 and back as ``repro`` rounds it, so the fit is ``repro``'s
    bit for bit (mivi: no EstParams)."""
    import jax.numpy as jnp
    from repro.distributed.kmeans import mesh_fit as jmesh_fit
    from repro.launch.mesh import make_test_mesh as jmesh

    from repro_torch.distributed.kmeans import mesh_fit

    state, hist, _, _ = mesh_fit(
        _port_docs(corpus[1]), K, make_test_mesh((1, 1), device="cpu"),
        algo="mivi", max_iter=MAX_ITER, obj_chunk=OBJ, seed_rows=corpus[2],
        lambda_dtype=torch.bfloat16)
    jstate, jhist, _, _ = jmesh_fit(
        corpus[0], K, jmesh((1, 1), ("data", "model")), algo="mivi",
        max_iter=MAX_ITER, obj_chunk=OBJ, seed=SEED,
        lambda_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(state.assign[:N_DOCS].numpy(),
                                  np.asarray(jstate.assign)[:N_DOCS])
    np.testing.assert_array_equal(state.means_t.numpy(),
                                  np.asarray(jstate.means_t))
    assert [h["n_changed"] for h in hist] == [int(h["n_changed"])
                                              for h in jhist]


@pytest.mark.parametrize("algo", ALGOS)
def test_model_split_equals_repro_and_lloyd(algo, world_12, repro_fits,
                                            lloyd_fits):
    got = world_12[0]
    assert _strip(got[0][("fit", algo)]["history"]) == \
        _strip(got[1][("fit", algo)]["history"])
    _same_as_lloyd(got[0][("fit", algo)], lloyd_fits[algo])
    _same_as_repro(got[0][("fit", algo)],
                   repro_fits((1, 2), ("data", "model"), algo), exact=True)


@pytest.mark.parametrize("where,algo", [
    ("(2, 2)", "esicp"), ("(2, 2)", "bounds-esicp"),
    ("(2, 1, 2)", "icp"), ("(2, 1, 2)", "bounds-esicp")])
def test_object_split_labels_equal_repro(where, algo, world_22, world_212,
                                         repro_fits):
    if where == "(2, 2)":
        got, shape, axes = world_22[0], (2, 2), ("data", "model")
    else:
        got, shape, axes = world_212, (2, 1, 2), ("pod", "data", "model")
    key = next(j for j in got[0] if j[:2] == ("fit", algo))
    for r in range(1, len(got)):       # every rank gathered the same fit
        for name in ("assign", "means"):
            np.testing.assert_array_equal(got[r][key][name],
                                          got[0][key][name])
    _same_as_repro(got[0][key], repro_fits(shape, axes, algo), exact=False)


def test_assign_fn_equals_classify_docs(world_22):
    rows = np.full(N_DOCS, -1)
    for r, out in enumerate(world_22[0]):
        row0, a, s, ref_a, ref_s = out["assign_fn"]
        np.testing.assert_array_equal(a, ref_a)
        np.testing.assert_array_equal(s, ref_s)
        rows[row0:row0 + len(a)] = a
    assert (rows >= 0).all() and (rows < K).all()


def test_store_input_equals_resident_fit(world_22):
    got = world_22[0][0]
    resident = got[("fit", "esicp", str(world_22[2] / "ckpt"))]
    store = got[("store", "esicp")]
    for name in ("assign", "rho", "means", "ub"):
        np.testing.assert_array_equal(store[name], resident[name],
                                      err_msg=name)
    assert _strip(store["history"]) == _strip(resident["history"])


def test_estimator_fits_predicts_saves_loads_on_mesh(world_22, repro_fits):
    labels, predicted, loaded, strategy, n_iter = \
        world_22[0][0][("estimator",)]
    ref = repro_fits((2, 2), ("data", "model"), "esicp")
    np.testing.assert_array_equal(labels, ref["assign"])
    assert strategy == "mesh" and n_iter == len(ref["history"])
    np.testing.assert_array_equal(loaded, predicted)


@pytest.mark.parametrize("who", ["port", "repro"])
def test_checkpoint_resumed_on_other_mesh(who, world_12, world_22,
                                          repro_fits):
    got, resumes = world_12
    resumed = got[0][("resume", resumes[who])]
    if who == "port":
        want = world_22[0][0][("fit", "esicp", str(world_22[2] / "ckpt"))]
        # the port's checkpoint carries the history so far
        assert [h["iteration"] for h in resumed["history"]] == [
            h["iteration"] for h in want["history"]]
    else:
        want = repro_fits((2, 2), ("data", "model"), "esicp")
        assert resumed["history"][0]["iteration"] == 3
    np.testing.assert_array_equal(resumed["assign"], want["assign"])


def test_mesh_checkpoint_format_is_repros(world_22, repro_fits):
    from repro.checkpoint import store as jckpt

    repro_fits((2, 2), ("data", "model"), "esicp")
    port_dir = str(world_22[2] / "ckpt")
    repro_dir = str(repro_fits.ckpt)
    def read(d):
        with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
            return json.load(f)

    mp, mr = read(port_dir), read(repro_dir)
    for field in ("treedef", "n_leaves", "shapes", "dtypes", "format"):
        assert mp[field] == mr[field], field
    example = {n: np.zeros(s, np.dtype(t)) for n, s, t in zip(
        ("assign", "iteration", "means_t", "moving", "rho_prev", "rho_self",
         "t_th", "ub", "v_th"), mp["shapes"], mp["dtypes"])}
    tree, step = jckpt.restore_checkpoint(port_dir, example, step=2)
    assert step == 2 and int(tree["iteration"]) == 2
    assert np.isfinite(np.asarray(tree["means_t"])).all()


def test_config_refusals():
    from repro_torch.cluster import ClusterConfig, SphericalKMeans
    from repro_torch.distributed.kmeans import make_step_fn, mesh_fit

    mesh = make_test_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="not available on the mesh"):
        ClusterConfig(k=8, algo="es", mesh=mesh, device="cpu").validate()
    with pytest.raises(ValueError, match="minibatch"):
        ClusterConfig(k=8, algo_mode="minibatch", mesh=mesh,
                      device="cpu").validate()
    with pytest.raises(ValueError, match="coarse_k"):
        ClusterConfig(k=8, coarse_k=2, mesh=mesh, device="cpu").validate()
    with pytest.raises(ValueError, match="device"):
        ClusterConfig(k=8, mesh=mesh).validate()
    with pytest.raises(ValueError, match="must divide"):
        ClusterConfig(k=7, mesh=type("M", (), {"shape": {"data": 1,
                                                         "model": 2}})(),
                      device="cpu").validate()
    with pytest.raises(ValueError, match="two_phase"):
        make_step_fn(mesh, k=8, two_phase=True)
    with pytest.raises(ValueError, match="two_phase"):
        mesh_fit(None, 8, mesh, two_phase=True)
    with pytest.raises(TypeError):
        mesh_fit(None, 8, mesh, taat_unroll=True)
    with pytest.raises(ValueError, match="not available on the mesh"):
        SphericalKMeans(8, algo="ta-icp", device="cpu", mesh=mesh).fit(None)
    assert ClusterConfig(k=8, mesh=mesh, device="cpu").strategy == "mesh"
    with pytest.raises(RuntimeError, match="default process group"):
        make_test_mesh((2, 2), device="cpu")


def test_step_watchdog():
    from repro_torch.distributed import StepWatchdog

    wd = StepWatchdog(factor=3.0, warmup=3)
    assert wd.budget is None
    with pytest.raises(RuntimeError, match="start"):
        wd.stop()
    for _ in range(3):
        wd.start()
        assert wd.stop() is False
    wd.times[:] = [0.01, 0.01, 0.01]
    assert wd.budget == pytest.approx(0.03)
    wd.start()
    time.sleep(0.05)
    assert wd.stop() is True
    wd.times[:] = [1.0] * 64
    wd.start()
    assert wd.stop() is False and len(wd.times) == 64


def test_sharded_batches_are_repros_and_split_by_shard(corpus):
    from repro.data.pipeline import ShardedBatches as JBatches

    from repro_torch.data import ShardedBatches

    docs, arrays, _ = corpus
    tdocs = _port_docs(arrays)
    want = list(JBatches(docs, 96, seed=3, drop_remainder=False).epoch(2))
    got = list(ShardedBatches(tdocs, 96, seed=3, drop_remainder=False,
                              device="cpu").epoch(2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for name in ("ids", "vals", "nnz"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)))
    shard = lambda i: type("Shard", (), {"object_size": 3,
                                         "object_index": i})()
    parts = [list(ShardedBatches(tdocs, 96, seed=3, mesh=shard(i),
                                 device="cpu").epoch(2, start_batch=1))
             for i in range(3)]
    whole = list(ShardedBatches(tdocs, 96, seed=3,
                                device="cpu").epoch(2, start_batch=1))
    assert len(whole) == 3
    for b, full in enumerate(whole):
        np.testing.assert_array_equal(
            torch.cat([p[b].ids for p in parts]).numpy(), full.ids.numpy())
    with pytest.raises(ValueError, match="divide"):
        ShardedBatches(tdocs, 95, mesh=shard(0), device="cpu")
    it = ShardedBatches(tdocs, 8, prefetch=1, device="cpu").epoch(0)
    next(it)
    it.close()                      # the producer stops, nothing hangs


def test_group_maxima_of_column_slices_assemble_the_whole():
    from repro_torch.core.assignment import _group_bounds
    from repro_torch.core.update import group_drift

    gen = torch.Generator().manual_seed(0)
    k, b = 40, 6                    # groups of 3, the last of 1
    sims = torch.rand((b, k), generator=gen)
    assign = torch.randint(0, k, (b,), generator=gen, dtype=torch.int32)
    old = torch.rand((50, k), generator=gen)
    new = torch.rand((50, k), generator=gen)
    whole_b = _group_bounds(sims, assign, k)
    whole_d = group_drift(new, old)
    for cut in (8, 20):             # two and five column blocks
        parts_b = [_group_bounds(sims[:, s:s + cut], assign, k, s)
                   for s in range(0, k, cut)]
        parts_d = [group_drift(new[:, s:s + cut], old[:, s:s + cut], k=k,
                               k0=s) for s in range(0, k, cut)]
        assert torch.equal(torch.stack(parts_b).amax(0), whole_b)
        assert torch.equal(torch.stack(parts_d).amax(0), whole_d)


def test_a_failing_rank_fails_the_world(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_local_world(_raise_on_rank_one, 2, timeout=60,
                        workdir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_local_world(_sleep_forever, 2, timeout=3, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_mesh_packages_import_no_jax():
    code = ("import sys, repro_torch.distributed, repro_torch.launch,"
            " repro_torch.data.pipeline;"
            " bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            " print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
