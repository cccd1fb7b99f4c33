"""The port's autotuner (``repro_torch.tune``) against ``repro.tune`` on
the CPU.

The knob vector validates, round-trips and refuses ``repro``'s engines;
the corpus signature's fields equal ``repro``'s; the search (with a pure
``measure``) is deterministic, always times the default, never picks a
winner slower than it and keeps to its budget; the cost model counts
what the tiles stage; ``ensure_tuned`` is None on CPU operands, where the
plain versions have no tiles, so a CPU fit with ``tune`` is the untuned
fit.  The fitted artifact loads in both directions: ``repro`` opens a port
artifact that carries the port's winner without taking it into its cache,
and the port carries a ``repro`` artifact's Pallas winner without taking
it into its own.  The launches themselves are held bit for bit on the
card (``tests/test_torch_cuda.py``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.cluster as jcluster  # noqa: E402
import repro.tune as jtune  # noqa: E402
from repro.sparse import SparseDocs as JDocs  # noqa: E402

from repro_torch.cluster import (ClusterConfig, FittedModel,  # noqa: E402
                                 SphericalKMeans)
from repro_torch.convert import docs_from_numpy  # noqa: E402
from repro_torch.core.backends import KernelBackend  # noqa: E402
from repro_torch.core.lloyd import lloyd_fit, streaming_fit  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse import DocStore  # noqa: E402
from repro_torch.tune import (DEFAULT_TUNED, TUNED_CACHE,  # noqa: E402
                              TunedConfig, corpus_signature, default_tuned)
from repro_torch.tune.config import TILES, instantiated  # noqa: E402
from repro_torch.tune.cost import (KernelShape, batch_work,  # noqa: E402
                                   feasible, kernel_flops_bytes,
                                   lower_bound_seconds, tile_distinct)
from repro_torch.tune.search import (SearchBudget,  # noqa: E402
                                     candidate_space, ensure_tuned,
                                     search_tuned_config)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small torch work: the suite's
    workers each starting one OpenMP thread per core oversubscribe the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_caches():
    TUNED_CACHE.clear()
    jtune.TUNED_CACHE.clear()
    yield
    TUNED_CACHE.clear()
    jtune.TUNED_CACHE.clear()


def _zipf(n=256, p=16, d=256, seed=0):
    """``repro``'s test corpus: zipf ids, sorted per row, all live."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, size=(n, p)), d)
    ids = np.sort((d - ranks).astype(np.int32), axis=1)
    vals = rng.random((n, p)).astype(np.float32)
    return ids, vals, np.full((n,), p, np.int32), d


def _tdocs(n=256, p=16, d=256, seed=0):
    ids, vals, nnz, d = _zipf(n, p, d, seed)
    return docs_from_numpy(ids, vals, nnz, d, device="cpu")


def _jdocs(n=256, p=16, d=256, seed=0):
    ids, vals, nnz, d = _zipf(n, p, d, seed)
    return JDocs(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                 nnz=jnp.asarray(nnz), dim=d)


def _no_elapsed(history):
    return [{k: v for k, v in row.items() if k != "elapsed_s"}
            for row in history]


# ---------------------------------------------------------------------------
# TunedConfig and the cache.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(sims_setting=4), dict(sims_setting=-1), dict(esicp_setting=4),
    dict(sims_setting=1.0), dict(slab_fastest=1), dict(engine="pallas"),
    dict(engine="xla_blocked")])
def test_tuned_config_refuses(bad):
    with pytest.raises(ValueError):
        TunedConfig(**bad)


def test_tuned_config_validates_and_roundtrips():
    cfg = TunedConfig(sims_setting=2, esicp_setting=1, slab_fastest=True,
                      source="search", signature="x")
    assert TunedConfig.from_dict(cfg.to_dict()) == cfg
    assert TunedConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg
    assert hash(cfg) == hash(cfg.replace())
    assert cfg.launch_setting("sims") == 6 and cfg.launch_setting("esicp") == 5
    assert DEFAULT_TUNED.launch_setting("sims") == 0 == \
        DEFAULT_TUNED.launch_setting("esicp")
    assert default_tuned() == DEFAULT_TUNED


@pytest.mark.parametrize("jcfg", [jtune.DEFAULT_TUNED,
                                  jtune.DEFAULT_XLA_TUNED,
                                  jtune.TunedConfig(b_blk=64, d_blk=128,
                                                    source="search",
                                                    signature="cpu/x")])
def test_repro_configs_are_refused(jcfg):
    """A config ``repro`` tuned for its engines never drives the port."""
    with pytest.raises(ValueError, match="engine"):
        TunedConfig.from_dict(jcfg.to_dict())


def test_instantiation_table():
    """Settings 0-3 and 4-7 (slabs fastest) of sims with and without
    counts and of esicp with counts; esicp without counts has 0 and 4."""
    for s in range(8):
        assert instantiated("sims", False, s) and instantiated("sims", True, s)
        assert instantiated("esicp", True, s)
        assert instantiated("esicp", False, s) == (s % 4 == 0)
    assert not instantiated("sims", True, 8)
    assert not instantiated("esicp", True, -1)


@pytest.mark.parametrize("n,p,d,seed", [(256, 16, 256, 0), (250, 16, 256, 0),
                                        (1000, 40, 2000, 3),
                                        (129, 7, 300, 5)])
def test_corpus_signature_equals_repros(n, p, d, seed):
    """b/p/d/k/occupancy fields equal ``repro``'s; the platform of CPU
    operands is 'cpu'; the engine suffix is the port's own."""
    ids, vals, _, d = _zipf(n, p, d, seed)
    vals[::7, -3:] = 0.0                       # some dead slots
    sig = corpus_signature(torch.from_numpy(ids), torch.from_numpy(vals),
                           dim=d, k=8)
    jsig = jtune.corpus_signature(ids, vals, dim=d, k=8, platform="cpu")
    assert sig.split("/")[:-1] == jsig.split("/")[:-1]
    assert sig.startswith("cpu/") and sig.endswith("/cuda")
    assert jsig.endswith("/pallas")
    assert corpus_signature(ids, vals, dim=d, k=8) == sig   # numpy too


def test_cache_puts_signature_and_roundtrips():
    cfg = TUNED_CACHE.put("sig-a", TunedConfig(sims_setting=1,
                                               source="search"))
    assert cfg.signature == "sig-a" and TUNED_CACHE.get("sig-a") == cfg
    assert "sig-a" in TUNED_CACHE and len(TUNED_CACHE) == 1
    dumped = TUNED_CACHE.to_dict()
    TUNED_CACHE.clear()
    assert len(TUNED_CACHE) == 0 and TUNED_CACHE.searches == 0
    TUNED_CACHE.from_dict(dumped)
    assert TUNED_CACHE.get("sig-a") == cfg


# ---------------------------------------------------------------------------
# The cost model.
# ---------------------------------------------------------------------------

def _brute_tile_rows(ids, vals, bt):
    return sum(len(set(ids[s:s + bt][vals[s:s + bt] != 0].tolist()))
               for s in range(0, ids.shape[0], bt))


@pytest.mark.parametrize("bt", [1, 7, 14, 28, 64, 300])
def test_tile_distinct_counts_the_staged_rows(bt):
    ids, vals, _, d = _zipf(200, 12, 256, seed=2)
    vals[::5, :4] = 0.0
    t = torch.from_numpy
    assert tile_distinct(t(ids), t(vals) != 0, d, bt) == \
        _brute_tile_rows(ids, vals, bt)


def test_bound_counts_bytes_and_operations():
    ids, vals, _, d = _zipf(300, 16, 256, seed=4)
    vals[1::3, -5:] = 0.0
    t = torch.from_numpy
    work = batch_work(t(ids), t(vals), d)
    assert work.live == int((vals != 0).sum())
    shape = KernelShape(b=300, p=16, d=d, k=50)
    for cfg in (DEFAULT_TUNED, TunedConfig(sims_setting=2, esicp_setting=1)):
        for kernel, g, planes in (("sparse_sim", "sims", 2),
                                  ("esicp_gather", "esicp", 4)):
            bt = TILES[g][getattr(cfg, f"{g}_setting")][0]
            flops, nbytes = kernel_flops_bytes(kernel, cfg, shape, work)
            assert flops == 2 * work.live * 50
            assert nbytes == (_brute_tile_rows(ids, vals, bt) * 50 * 4
                              + 300 * 16 * 8 + planes * 300 * 50 * 4)
    # A smaller tile stages more rows: esicp at 7 documents bounds above 14.
    lo = lower_bound_seconds(DEFAULT_TUNED, shape, work)
    hi = lower_bound_seconds(TunedConfig(esicp_setting=1), shape, work)
    assert hi > lo > 0
    # Columns per slab and grid order move no byte: equal bounds.
    assert lower_bound_seconds(TunedConfig(sims_setting=3, esicp_setting=3,
                                           slab_fastest=True), shape,
                               work) == lower_bound_seconds(
        TunedConfig(esicp_setting=3), shape, work)
    with pytest.raises(ValueError):
        kernel_flops_bytes("segment_update", DEFAULT_TUNED, shape, work)


def test_feasibility_gate():
    cfg = TunedConfig(sims_setting=3, esicp_setting=2, slab_fastest=True)
    assert feasible(cfg)
    assert feasible(cfg, blocks_per_sm=lambda mode, s, c: 2)
    assert not feasible(cfg, blocks_per_sm=lambda mode, s, c: 0 if s == 7
                        else 2)


@pytest.mark.parametrize("b,k,n", [(4096, 10_000, 32), (5, 10_000, 16),
                                   (4096, 100, 16), (4096, 200, 23),
                                   (28, 300, 28)])
def test_candidate_space_dedups_on_the_launches(b, k, n):
    """Grid order matters only where a gather has more than one tile and
    more than one slab."""
    space = candidate_space(KernelShape(b=b, p=8, d=1000, k=k))
    assert space[0] == DEFAULT_TUNED and len(space) == n
    keys = [c.geometry_key(b=b, p=8, d=1000, k=k) for c in space]
    assert len(set(keys)) == len(keys)


# ---------------------------------------------------------------------------
# The search, with a pure measure.
# ---------------------------------------------------------------------------

def _measure(cfg):
    """A pure function of the candidate: the default is not the fastest."""
    return (1.0 + 0.1 * ((cfg.sims_setting + 1) % 4)
            + 0.05 * ((cfg.esicp_setting + 2) % 4) + 0.01 * cfg.slab_fastest)


@pytest.mark.parametrize("max_timed", [1, 2, 5, 8, 40])
def test_search_times_the_default_and_keeps_to_its_budget(max_timed):
    ids, vals, _, d = _zipf(seed=1)
    timed = []

    def counting(cfg):
        timed.append(cfg)
        return _measure(cfg)

    budget = SearchBudget(max_timed=max_timed, repeat=1, probe_rows=256)
    winner, stats = search_tuned_config(ids, vals, dim=d, k=300,
                                        budget=budget, measure=counting)
    assert stats.n_candidates == len(candidate_space(
        KernelShape(b=256, p=16, d=d, k=300)))
    # repro's rule keeps one candidate beside the default at max_timed 1
    assert stats.n_timed == len(timed) <= max(max_timed, 2)
    assert stats.n_pruned == stats.n_candidates - stats.n_timed
    assert any(c == DEFAULT_TUNED for c in timed)
    assert stats.best_measured_s <= stats.default_measured_s
    assert stats.best_measured_s == _measure(winner)
    assert winner.source == ("default" if winner == DEFAULT_TUNED.replace(
        source="default") else "search")
    assert len(stats.candidates) == stats.n_candidates
    assert sum(not c["pruned"] for c in stats.candidates) == stats.n_timed
    assert all((c["measured_s"] is None) == c["pruned"]
               for c in stats.candidates)


def test_search_is_deterministic_under_a_fixed_seed_and_budget():
    ids, vals, _, d = _zipf(seed=3)
    budget = SearchBudget(max_timed=5, repeat=1, probe_rows=200)
    out = [search_tuned_config(ids, vals, dim=d, k=64, budget=budget,
                               seed=7, measure=_measure) for _ in range(2)]
    (w1, s1), (w2, s2) = out
    assert w1 == w2 and s1.to_dict() == s2.to_dict()
    assert s1.candidates == s2.candidates


def test_search_prunes_on_the_bound():
    """Survivors rank by (bound, index); a candidate over PRUNE_SLACK ×
    the default's bound is never timed, however fast it would be."""
    ids, vals, _, d = _zipf(seed=5)
    stats = search_tuned_config(ids, vals, dim=d, k=64, budget=3,
                                measure=_measure, prune_slack=1.0)[1]
    bounds = {json.dumps(c["config"], sort_keys=True): c["bound_s"]
              for c in stats.candidates}
    timed = [json.dumps(c["config"], sort_keys=True)
             for c in stats.candidates if not c["pruned"]]
    assert all(bounds[t] <= stats.default_bound_s for t in timed)
    untimed = [b for key, b in bounds.items() if key not in timed]
    assert stats.n_timed == 3 or not untimed or \
        min(untimed) > stats.default_bound_s


def test_search_needs_a_measure_on_the_cpu():
    ids, vals, _, d = _zipf()
    with pytest.raises(ValueError, match="CUDA"):
        search_tuned_config(torch.from_numpy(ids), torch.from_numpy(vals),
                            dim=d, k=8, budget=1)


# ---------------------------------------------------------------------------
# ensure_tuned, the backend and the fits: a no-op on the CPU.
# ---------------------------------------------------------------------------

def test_ensure_tuned_modes_on_cpu_operands():
    docs = _tdocs()
    with pytest.raises(ValueError):
        ensure_tuned(docs, k=8, mode="always")
    assert ensure_tuned(docs, k=None, mode="search") is None
    # Even a cached winner for the signature: the plain versions have no
    # tiles, so nothing is returned and nothing is searched.
    sig = corpus_signature(docs.ids, docs.vals, dim=docs.dim, k=8)
    TUNED_CACHE.put(sig, TunedConfig(sims_setting=1, source="search"))
    for mode in ("cached", "search"):
        assert ensure_tuned(docs, k=8, mode=mode) is None
    assert TUNED_CACHE.searches == 0 and len(TUNED_CACHE) == 1


def test_prepare_returns_the_backend_the_fit_runs():
    docs = _tdocs()
    bk = KernelBackend()
    assert bk.prepare(docs, k=8) is bk and bk.tuned is None
    got = bk.prepare(docs, k=8, tune="search", tune_budget=2)
    assert isinstance(got, KernelBackend) and got.tuned is None
    with pytest.raises(ValueError):
        bk.prepare(docs, k=8, tune="fast")


def test_ops_check_and_ignore_the_config_on_cpu():
    docs = _tdocs(n=40)
    means = torch.rand((docs.dim, 12), generator=torch.Generator()
                       .manual_seed(0))
    args = (docs.ids, docs.vals, means)
    want = ops.sparse_sim(*args, with_counts=True)
    cfg = TunedConfig(sims_setting=2, esicp_setting=1, slab_fastest=True)
    got = ops.sparse_sim(*args, with_counts=True, tuned=cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    want = ops.esicp_gather(*args, 200, 0.2, with_counts=True)
    got = ops.esicp_gather(*args, 200, 0.2, with_counts=True, tuned=cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.sparse_sim(*args, square=True, tuned=cfg)[0] is not None
    with pytest.raises(TypeError):
        ops.sparse_sim(*args, tuned={"sims_setting": 1})
    with pytest.raises(ValueError, match="without counts"):
        ops.esicp_gather(*args, 200, 0.2, tuned=cfg)


@pytest.mark.parametrize("algo", ["esicp", "mivi", "cs-icp", "bounds"])
def test_cpu_fit_with_tune_is_the_untuned_fit(algo):
    docs = _tdocs(n=300, p=16, d=256, seed=1)
    rows = torch.arange(0, 300, 50)
    base = lloyd_fit(docs, k=6, algo=algo, batch_size=128, max_iter=3,
                     seed_rows=rows, device="cpu")
    tuned = lloyd_fit(docs, k=6, algo=algo, batch_size=128, max_iter=3,
                      seed_rows=rows, device="cpu", tune="search",
                      tune_budget=SearchBudget(max_timed=2, repeat=1))
    assert tuned.tuned is None and base.tuned is None
    assert torch.equal(tuned.assign, base.assign)
    assert _no_elapsed(tuned.history) == _no_elapsed(base.history)
    store = DocStore.from_docs(docs, chunk_size=100)
    st = streaming_fit(store, k=6, algo=algo, batch_size=128, max_iter=3,
                       seed_rows=rows, device="cpu", tune="cached")
    assert st.tuned is None and torch.equal(st.assign, base.assign)
    assert TUNED_CACHE.searches == 0


def test_config_and_estimator_take_tune():
    ClusterConfig(k=4, tune="search", tune_budget=3).validate()
    ClusterConfig(k=4, tune="cached").validate()
    with pytest.raises(ValueError, match="tune"):
        ClusterConfig(k=4, tune="aggressive").validate()
    budget = SearchBudget(max_timed=2)
    km = SphericalKMeans(4, tune="search", tune_budget=budget, device="cpu")
    assert km.config.tune == "search" and km.config.tune_budget == budget
    assert SphericalKMeans.from_config(km.config).config == km.config
    km.fit(_tdocs(n=120), seed_rows=torch.arange(4))
    assert km.model_.cuda_tuned is None and km.model_.tuned is None
    two = SphericalKMeans(6, coarse_k=2, max_iter=2, tune="search",
                          device="cpu").fit(_tdocs(n=120))
    assert two.model_.cuda_tuned is None


# ---------------------------------------------------------------------------
# The artifact, both ways.
# ---------------------------------------------------------------------------

def _port_model(n=200, k=5):
    km = SphericalKMeans(k, max_iter=2, device="cpu").fit(
        _tdocs(n=n), seed_rows=torch.arange(k))
    return km.model_


def test_port_artifact_with_a_winner_loads_in_repro(tmp_path):
    model = _port_model()
    winner = TUNED_CACHE.put(
        "NVIDIA H100 80GB HBM3/b4096/p512/d495126/k10000/occ0.35/cuda",
        TunedConfig(sims_setting=1, esicp_setting=1, slab_fastest=True,
                    source="search"))
    model.cuda_tuned = winner.to_dict()
    path = str(tmp_path / "m")
    model.save(path)
    with open(os.path.join(path, "step_00000000", "extra.json")) as f:
        extra = json.load(f)
    assert extra["tuned"] is None and extra["cuda_tuned"] == winner.to_dict()

    jm = jcluster.FittedModel.load(path)
    assert jm.tuned is None
    assert len(jtune.TUNED_CACHE) == 0
    assert not any(sig.endswith("/cuda")
                   for sig in jtune.TUNED_CACHE.to_dict())
    np.testing.assert_array_equal(jm.labels, model.labels.numpy())

    TUNED_CACHE.clear()
    back = FittedModel.load(path, device="cpu")
    assert back.cuda_tuned == winner.to_dict() and back.tuned is None
    assert TUNED_CACHE.get(winner.signature) == winner
    # A servable built from an in-memory model seeds the cache too.
    TUNED_CACHE.clear()
    back.servable(device="cpu")
    assert TUNED_CACHE.get(winner.signature) == winner


def test_repro_artifact_with_a_pallas_winner_loads_in_the_port(tmp_path):
    jdocs = _jdocs(n=192, p=16, d=256, seed=2)
    jm = jcluster.fit(jdocs, jcluster.ClusterConfig(
        k=6, algo="esicp", backend="reference", max_iter=2,
        batch_size=192))
    sig = jtune.corpus_signature(jdocs.ids, jdocs.vals, dim=256, k=6,
                                 platform="cpu")
    jm.tuned = jtune.TunedConfig(b_blk=64, d_blk=128, source="search",
                                 signature=sig).to_dict()
    path = str(tmp_path / "j")
    jm.save(path)
    jtune.TUNED_CACHE.clear()

    tm = FittedModel.load(path, device="cpu")
    assert tm.tuned == jm.tuned and tm.cuda_tuned is None
    assert len(TUNED_CACHE) == 0
    tm.servable(device="cpu")
    assert len(TUNED_CACHE) == 0
    again = str(tmp_path / "again")
    tm.save(again)
    with open(os.path.join(again, "step_00000000", "extra.json")) as f:
        extra = json.load(f)
    assert extra["tuned"] == jm.tuned and extra["cuda_tuned"] is None
    jback = jcluster.FittedModel.load(again)
    assert jback.tuned == jm.tuned
    assert jtune.TUNED_CACHE.get(sig) == jtune.TunedConfig.from_dict(
        jm.tuned)
