"""The port's data layer against ``repro``'s: the synthetic corpus, the
sparse-matrix builders, and the float32 quantile/linspace helpers EstParams
relies on.  Inputs come from numpy with fixed seeds; both packages run on
the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import sparse as jsp  # noqa: E402
from repro.data import CorpusSpec as JSpec, make_corpus as jmake  # noqa: E402
from repro_torch import sparse as tsp  # noqa: E402
from repro_torch.core.estparams import linspace_f32, nanquantile  # noqa: E402
from repro_torch.data import CorpusSpec, make_corpus  # noqa: E402

SPECS = [
    dict(n_docs=600, vocab=1024, nt_mean=35, n_topics=16, seed=7),
    dict(n_docs=300, vocab=5000, nt_mean=60, n_topics=8, seed=3, pad_to=20),
]


@pytest.mark.parametrize("spec", SPECS)
def test_corpus_identical(spec):
    """ids, nnz, df, perm and topics identical; vals within 1e-6."""
    jd, jdf, jperm, jt = jmake(JSpec(**spec))
    td, tdf, tperm, tt = make_corpus(CorpusSpec(**spec), device="cpu")
    np.testing.assert_array_equal(np.asarray(jd.ids), td.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jd.nnz), td.nnz.numpy())
    np.testing.assert_array_equal(np.asarray(jdf), tdf.numpy())
    np.testing.assert_array_equal(np.asarray(jdf), td.df.numpy())
    np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_allclose(np.asarray(jd.vals), td.vals.numpy(),
                               rtol=0, atol=1e-6)


def _raw_docs(rng, n=40, d=64, p=12):
    x = np.where(rng.random((n, d)) < 0.12,
                 rng.integers(1, 5, (n, d)), 0).astype(np.float32)
    return x


def test_sparse_builders_match_repro():
    rng = np.random.default_rng(11)
    x = _raw_docs(rng)
    jd = jsp.from_dense(x, pad_to=16)
    td = tsp.from_dense(x, pad_to=16, device="cpu")
    np.testing.assert_array_equal(np.asarray(jd.ids), td.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jd.nnz), td.nnz.numpy())
    np.testing.assert_array_equal(np.asarray(jsp.to_dense(jd)),
                                  tsp.to_dense(td).numpy())
    np.testing.assert_array_equal(np.asarray(jsp.df_counts(jd)),
                                  tsp.df_counts(td).numpy())
    jw = jsp.l2_normalize_rows(jsp.tf_idf(jd))
    tw = tsp.l2_normalize_rows(tsp.tf_idf(td))
    np.testing.assert_allclose(np.asarray(jw.vals), tw.vals.numpy(),
                               rtol=0, atol=1e-6)
    jr, jperm = jsp.remap_terms_by_df(jw)
    tr, tperm = tsp.remap_terms_by_df(tw)
    np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
    np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jr.df), tr.df.numpy())
    np.testing.assert_allclose(np.asarray(jr.vals), tr.vals.numpy(),
                               rtol=0, atol=1e-6)
    jp = jsp.pad_rows(jr, 16)
    tp = tsp.pad_rows(tr, 16)
    assert tp.n_docs == jp.n_docs == 48
    np.testing.assert_array_equal(np.asarray(jp.nnz), tp.nnz.numpy())
    np.testing.assert_array_equal(np.asarray(jp.ids), tp.ids.numpy())


def test_validate_rejects_out_of_range_ids():
    td = tsp.from_dense(np.eye(4, dtype=np.float32), device="cpu")
    bad = tsp.SparseDocs(td.ids + 4, td.vals, td.nnz, td.dim)
    with pytest.raises(ValueError, match="term ids"):
        bad.validate()


@pytest.mark.parametrize("n,nan_frac", [(1, 0.0), (7, 0.3), (1000, 0.5),
                                        (20_000, 0.9)])
def test_nanquantile_small_matches_jnp(n, nan_frac):
    rng = np.random.default_rng(n)
    a = rng.random(n).astype(np.float32)
    a[rng.random(n) < nan_frac] = np.nan
    qs = np.asarray(jnp.linspace(0.5, 0.999, 24))
    want = np.asarray(jnp.nanquantile(jnp.asarray(a), jnp.asarray(qs)))
    got = nanquantile(torch.from_numpy(a[~np.isnan(a)]),
                      torch.from_numpy(qs.copy()))
    np.testing.assert_array_equal(want, got.numpy())


def test_nanquantile_above_2_24_elements():
    """torch.quantile refuses inputs above 2^24 elements; the port's
    nanquantile agrees with jnp.nanquantile on such an input."""
    n = (1 << 24) + 4099
    rng = np.random.default_rng(5)
    a = rng.random(n, dtype=np.float32)
    a[rng.random(n) < 0.7] = np.nan
    qs = np.asarray(jnp.linspace(0.5, 0.999, 24))
    want = np.asarray(jnp.nanquantile(jnp.asarray(a), jnp.asarray(qs)))
    got = nanquantile(torch.from_numpy(a[~np.isnan(a)]),
                      torch.from_numpy(qs.copy()))
    np.testing.assert_array_equal(want, got.numpy())
    with pytest.raises(RuntimeError, match="too large"):
        torch.nanquantile(torch.from_numpy(a), torch.from_numpy(qs))


@pytest.mark.parametrize("start,stop,num", [
    (0.5, 0.999, 24), (819, 1024, 48), (396100, 495126, 48),
    (int(0.8 * 141043), 141043, 48), (int(0.8 * 16384), 16384, 48)])
def test_linspace_f32_matches_jnp(start, stop, num):
    """The EstParams candidate grids (n_v 24 quantiles, n_s 48 term
    thresholds) match jnp.linspace bit for bit, at the vocabularies the
    repo's configs use (NYT 495,126; PubMed 141,043)."""
    want = np.asarray(jnp.linspace(start, stop, num))
    got = linspace_f32(start, stop, num).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(want.astype(np.int32), got.astype(np.int32))
