"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless torch sees a CUDA device (decided
inside the fixture, never at import).  Run on an H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes cover what ``chip_smoke.py`` does not.  For the gather's
document tiles (28 documents x 256 columns for sims, 14 x 256 for the ES
modes, staged 32 distinct rows at a time in a ring of three): B not a
multiple of the tile, K not a multiple of the column slab and K = 1, K not
a multiple of 4 (rows copied by the producer warp, not in bulk), more
distinct rows in a tile than the ring holds (P 600), tiles whose documents
share no id and tiles of identical documents, rows whose live ids do not
ascend (the plan's slot-order walk), t_th at 0, inside and at D, every
tile setting of ``scripts/gather_probe.py``, the square variant at t_th 0
(each row's head on the tile, its live id-0 slots after it walked); beside them dead slots, empty
rows, duplicate ids and assignments outside [0, K).  For segment_update K above one
shared-memory column tile and a term with 12,000 postings; for sketch_sim
tiles whose leading s are all zero.  Kernel and plain version add in the
same order without fused multiply-adds, so they must agree bit for bit;
the plain segment_update on the card uses atomics (``index_add_``), so λ is
compared bitwise against the CPU plain version instead.  This file imports
neither JAX nor ``repro``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(37, 600, 2000, 1500), (4096, 64, 5000, 300), (9, 5, 50, 1)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, p, d, k, seed):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, p + 1, b)
    ids = np.zeros((b, p), np.int32)
    vals = np.zeros((b, p), np.float32)
    for i in range(b):
        m = min(nnz[i], d)
        ids[i, :m] = np.sort(rng.choice(d, m, replace=False))
        vals[i, :m] = rng.random(m) + 0.05
        if m >= 2 and i % 3 == 0:
            ids[i, 1] = ids[i, 0]                    # duplicate id, both live
    means = rng.random((d, k)).astype(np.float32)
    means[rng.random((d, k)) < 0.6] = 0.0
    assign = rng.integers(0, k, b).astype(np.int32)
    assign[::5] = k
    assign[1::7] = -1
    t = lambda a: torch.from_numpy(a)
    return t(ids), t(vals), t(means), t(assign)


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_kernels_equal_plain(dev, shape):
    ids, vals, means, _ = _inputs(*shape, seed=1)
    t_th, v_th = int(0.7 * shape[2]), 0.4
    g = [x.to(dev) for x in (ids, vals, means)]
    ops.reset_counts()
    got = ops.esicp_gather(*g, t_th, v_th, with_counts=True)
    want = ref.esicp_gather(*g, t_th, v_th, with_counts=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sims, counts = ops.sparse_sim(*g, with_counts=True)
    w_sims, w_counts = ref.sparse_sim(*g, with_counts=True)
    assert torch.equal(sims, w_sims) and torch.equal(counts, w_counts)
    assert torch.equal(sims, got[2])
    assert ops.LAUNCHES["esicp_gather"] == ops.LAUNCHES["sparse_sim"] == 1
    assert ops.PLAIN["esicp_gather"] == ops.PLAIN["sparse_sim"] == 0


def _tile_case(case):
    """(ids, vals, means, D) of one gather tile edge (numpy, seeded)."""
    rng = np.random.default_rng(len(case))
    if case == "disjoint":                  # no id shared within a tile
        b, p, d, k = 70, 40, 70 * 40, 300
        ids = np.arange(b * p, dtype=np.int32).reshape(b, p)
    elif case == "identical":               # every document the same
        b, p, d, k = 130, 90, 500, 257
        row = np.sort(rng.choice(d, p, replace=True)).astype(np.int32)
        ids = np.tile(row, (b, 1))
    else:                                   # "unordered": some rows shuffled
        b, p, d, k = 37, 600, 2000, 1500
        ids, vals, means, _ = (x.numpy() for x in _inputs(b, p, d, k, 11))
        for i in range(0, b, 4):
            n = int((vals[i] != 0).sum())
            perm = rng.permutation(n)
            ids[i, :n], vals[i, :n] = ids[i, perm], vals[i, perm]
        return ids, vals, means, d
    vals = (rng.random((b, p)) + 0.05).astype(np.float32)
    vals[:, -3:] = 0.0                      # dead slots at the end
    means = rng.random((d, k)).astype(np.float32)
    means[rng.random((d, k)) < 0.5] = 0.0
    return ids, vals, means, d


@pytest.mark.parametrize("case", ["disjoint", "identical", "unordered"])
@pytest.mark.parametrize("t_frac", [0.0, 0.5, 1.0])
def test_gather_tile_edges_equal_plain(dev, case, t_frac):
    """The tiled gather at its edges, sims, ES and TA modes with counts,
    bit for bit; t_th at 0 (all tail), inside, and at D (no tail)."""
    ids, vals, means, d = _tile_case(case)
    g = [torch.from_numpy(x).to(dev) for x in (ids, vals, means)]
    t_th = int(t_frac * d)
    v_ta = torch.rand((ids.shape[0],), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev) * 0.8
    ops.reset_counts()
    for kw in ({}, {"v_ta": v_ta}):
        got = ops.esicp_gather(*g, t_th, 0.4, with_counts=True, **kw)
        want = ref.esicp_gather(*g, t_th, 0.4, with_counts=True, **kw)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    sims, counts = ops.sparse_sim(*g, with_counts=True)
    w_sims, w_counts = ref.sparse_sim(*g, with_counts=True)
    assert torch.equal(sims, w_sims) and torch.equal(counts, w_counts)
    assert torch.equal(ops.sparse_sim(*g)[0], w_sims)
    assert sum(ops.PLAIN.values()) == 0


@pytest.mark.parametrize("setting", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_tile_settings_equal_plain(dev, setting, shape):
    """Every tile setting the probe times (4: setting 0 with the column
    slabs fastest in the grid): sims without counts, square at t_th = 0
    (settings 0 and 4, its only ones) and esicp with counts, bit for
    bit."""
    from repro_torch.kernels import esicp_gather as kern

    ids, vals, means, _ = _inputs(*shape, seed=12)
    b, p, d, k = shape
    g = [x.to(dev) for x in (ids, vals, means)]
    lib = kern.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    t_th, v_th = int(0.7 * d), 0.4
    out = [torch.empty((b, k), device=dev) for _ in range(3)]
    cnt = torch.empty((b, k), dtype=torch.int32, device=dev)
    ones = (g[0] >= 0).to(torch.float32)
    for mode, counts in ((kern.SIMS, None), (kern.SQUARE, None),
                         (kern.ESICP, cnt)):
        if lib.gather_tile_docs(mode, setting) < 0:
            assert mode == kern.SQUARE and setting in (1, 2, 3)
            continue
        x = (g[0], ones, g[2]) if mode == kern.SQUARE else g
        scratch = kern.scratch(lib, g[0], d, mode, setting)
        rc = lib.gather_setting_launch(
            mode, setting, *(t.data_ptr() for t in x), b, p, d, k,
            float(t_th), v_th, None, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), None if counts is None else counts.data_ptr(),
            scratch.data_ptr(), stream)
        assert rc == 0
        torch.cuda.synchronize()
        if mode == kern.SIMS:
            assert torch.equal(out[2], ref.sparse_sim(*g)[0])
        elif mode == kern.SQUARE:
            assert torch.equal(out[2], ref.sparse_sim(*x, square=True)[0])
        else:
            want = ref.esicp_gather(*g, t_th, v_th, with_counts=True)
            for a, w in zip((*out, cnt), want):
                assert torch.equal(a, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_esicp_filter_equal_plain(dev, shape):
    b, _, _, k = shape
    gen = torch.Generator(device=dev).manual_seed(2)
    rho12 = torch.rand((b, k), generator=gen, device=dev)
    y = torch.rand((b, k), generator=gen, device=dev)
    rho_max = torch.rand((b,), generator=gen, device=dev) * 1.5
    rho_max[0] = -torch.inf
    col_ok = torch.rand((b, k), generator=gen, device=dev) < 0.7
    got = ops.esicp_filter(rho12, y, rho_max, col_ok, 0.3)
    want = ref.esicp_filter(rho12, y, rho_max, col_ok, 0.3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# Beside SHAPES: K above one shared-memory column tile (most clusters
# empty), and one term with 12,000 postings.
SEGMENT_SHAPES = SHAPES + [(300, 50, 2000, 20_000), (12_000, 8, 64, 37)]


@pytest.mark.parametrize("shape", SEGMENT_SHAPES)
def test_segment_update_bitwise(dev, shape):
    """Kernel vs the CPU plain version bit for bit, twice from the
    documents' term-major layout, which is built once; assignments K and
    -1, duplicate ids, dead slots."""
    from repro_torch.sparse.matrix import SparseDocs

    b, _, d, k = shape
    ids, vals, _, assign = _inputs(*shape, seed=3)
    if b >= 10_000:                      # term 0 in every row
        ids[:, 0] = 0
        vals[:, 0] = 0.25
    nnz = (vals != 0).sum(dim=1, dtype=torch.int32)
    docs = SparseDocs(ids.to(dev), vals.to(dev), nnz.to(dev), d)
    assert docs.to("cuda") is docs                   # a fit keeps the layout
    g = assign.to(dev)
    ops.reset_counts()
    one = ops.segment_update(g, docs, k=k)
    layout = docs.by_term
    two = ops.segment_update(g, docs, k=k)
    torch.cuda.synchronize()
    assert docs.by_term is layout
    assert ops.LAUNCHES["segment_update"] == 2
    assert ops.PLAIN["segment_update"] == 0
    assert torch.equal(one, two)                      # no atomics
    assert torch.equal(one.cpu(), ref.segment_update(assign, ids, vals, k, d))
    torch.testing.assert_close(
        one, ref.segment_update(g, docs.ids, docs.vals, k, d), rtol=1e-4,
        atol=1e-4)
    if b >= 10_000:
        assert int(layout.ptr[1]) >= 10_000


@pytest.mark.parametrize("shape", SHAPES)
def test_rho_gather_equal_plain(dev, shape):
    ids, vals, means, assign = _inputs(*shape, seed=4)
    g = [x.to(dev) for x in (assign, ids, vals, means)]
    got = ops.rho_gather(*g)
    assert torch.equal(got, ref.rho_gather(*g))
    assert torch.equal(got.cpu(), ref.rho_gather(assign, ids, vals, means))
    assert bool((got[::5] == 0).all()) and bool((got[1::7] == 0).all())


def test_cuda_operand_the_kernel_cannot_take_raises(dev):
    ids, vals, means, _ = _inputs(8, 6, 40, 3, seed=5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sparse_sim(ids.to(dev).t().contiguous().t(), vals.to(dev),
                       means.to(dev))
    with pytest.raises(ValueError, match="several devices"):
        ops.sparse_sim(ids.to(dev), vals, means.to(dev))


@pytest.mark.parametrize("b,s,k,lead", [
    (33, 1, 1, 0), (4097, 64, 130, 0), (5, 37, 1, 0), (70, 64, 10_000, 0),
    (4097, 64, 130, 20), (256, 64, 300, 6), (300, 7, 259, 3),
    (129, 1, 5, 1)])
def test_sketch_sim_equal_plain(dev, b, s, k, lead):
    """B not a multiple of the 128-row tile, K = 1, S in {1, 7, 37, 64}, K
    not a multiple of the 128-column tile; the first row tile's x zero in
    its ``lead`` leading s (the kernel's zero skip; lead 6 of 64: few
    enough that they are added, as ±0; lead = S: nothing to add);
    binarised operands count exactly."""
    gen = torch.Generator().manual_seed(b + s + k + lead)
    x = torch.rand((b, s), generator=gen)
    x[torch.rand((b, s), generator=gen) < 0.4] = 0.0
    x[:128, :lead] = 0.0
    m = torch.rand((s, k), generator=gen)
    ops.reset_counts()
    got = ops.sketch_sim(x.to(dev), m.to(dev))
    assert torch.equal(got, ref.sketch_sim(x.to(dev), m.to(dev)))
    assert torch.equal(got.cpu(), ref.sketch_sim(x, m))
    xb, mb = (x > 0).float(), (m > 0.5).float()
    pairs = ops.sketch_sim(xb.to(dev), mb.to(dev))
    assert torch.equal(pairs.cpu(), (xb.double() @ mb.double()).float())
    assert ops.LAUNCHES["sketch_sim"] == 2 and ops.PLAIN["sketch_sim"] == 0


@pytest.mark.parametrize("d", [300, 495_126])
def test_doc_sketch_equal_plain(dev, d):
    """Ids at the last group (clip boundary), dead slots with id 0, an
    empty row, and more slots than a warp's pass."""
    from repro_torch.core.meanindex import sketch_size

    ids, vals, _, _ = _inputs(41, 100, min(d, 5000), 2, seed=6)
    ids[3, :3] = torch.tensor([d - 3, d - 2, d - 1], dtype=torch.int32)
    vals[3, :3] = 0.5
    vals[4] = 0.0                                   # an empty row
    s = sketch_size(d)
    got = ops.doc_sketch(ids.to(dev), vals.to(dev), d, s)
    assert got.shape == (41, s)
    assert torch.equal(got, ref.doc_sketch(ids.to(dev), vals.to(dev), d, s))
    assert torch.equal(got.cpu(), ref.doc_sketch(ids, vals, d, s))
    assert float(got[3, s - 1]) > 0 and bool((got[4] == 0).all())


def _sketch_rows(b, p, s, order, seed):
    """(ids, vals, d) for doc_sketch: g = ceil(d / S) with d = S·g - 3;
    ids at g·t - 1 and g·t, in the last group and past S·g (the clip), 0,
    2**31 - 1 and negative; dead slots (v = 0) among the live ones; row 0
    empty, row 1 in one group; rows ascending, shuffled, or with each id
    twice in a row (both live)."""
    rng = np.random.default_rng(seed)
    g = 7737 if s == 64 else 5 + s
    d = s * g - (3 if s > 3 else 0)
    edges = np.concatenate([np.arange(1, s + 1) * g - 1, np.arange(s) * g,
                            [d - 1, s * g, s * g + 5, 2**31 - 1, -1, -7]])
    ids = np.where(rng.random((b, p)) < 0.3,
                   rng.choice(edges, (b, p)), rng.integers(0, d, (b, p)))
    vals = (rng.random((b, p)) + 0.05).astype(np.float32)
    vals[rng.random((b, p)) < 0.2] = 0.0
    vals[0] = 0.0
    if b > 1:
        ids[1] = g * (s // 2) + rng.integers(0, g, p)
    if order == "sorted":
        ids.sort(axis=1)
    elif order == "duplicates":
        ids.sort(axis=1)
        ids[:, 1::2] = ids[:, 0::2][:, :ids[:, 1::2].shape[1]]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(ids.astype(np.int32)), t(vals), d


@pytest.mark.parametrize("order", ["sorted", "unsorted", "duplicates"])
@pytest.mark.parametrize("b,p,s", [(1, 5, 1), (33, 31, 7), (33, 100, 37),
                                   (4097, 429, 64), (33, 429, 64),
                                   (4097, 40, 7), (33, 300, 1)])
def test_doc_sketch_rows_equal_plain(dev, b, p, s, order):
    """B in {1, 33, 4097} (not a multiple of the 16-row block), P below
    32, not a multiple of 32 and 429 (several 128-slot chunks), S in {1,
    7, 37, 64}; every case of ``_sketch_rows``: bit for bit against the
    plain version on the card and on the CPU."""
    ids, vals, d = _sketch_rows(b, p, s, order, seed=b + p + s)
    ops.reset_counts()
    got = ops.doc_sketch(ids.to(dev), vals.to(dev), d, s)
    assert ops.LAUNCHES["doc_sketch"] == 1 and ops.PLAIN["doc_sketch"] == 0
    assert got.shape == (b, s)
    assert torch.equal(got, ref.doc_sketch(ids.to(dev), vals.to(dev), d, s))
    assert torch.equal(got.cpu(), ref.doc_sketch(ids, vals, d, s))
    assert bool((got[0] == 0).all())
    if b > 1 and s > 1:
        assert int((got[1] != 0).sum()) == 1


def _rho_case(shape, case, seed):
    """``_inputs`` with values and ids past each row's nnz, and the
    assignment of ``case``: as drawn (-1 and K among them), every document
    in one centroid, or only every third centroid used."""
    b, p, d, k = shape
    ids, vals, means, assign = _inputs(b, p, d, k, seed)
    nnz = (vals != 0).sum(dim=1, dtype=torch.int32)
    past = torch.arange(p)[None, :] >= nnz[:, None]
    gen = torch.Generator().manual_seed(seed)
    d_vals = torch.where(past, torch.rand((b, p), generator=gen) + 0.5, vals)
    d_ids = torch.where(past, torch.randint(0, d, (b, p), generator=gen,
                                            dtype=torch.int32), ids)
    if case == "one_centroid":
        assign = torch.full_like(assign, k // 2)
    elif case == "empty_centroids":
        assign = (assign % max(k // 3, 1)) * 3
        assign[::5] = k
        assign[1::7] = -1
    return d_ids, d_vals, nnz, means, assign, torch.where(past, 0.0, vals)


@pytest.mark.parametrize("case", ["drawn", "one_centroid", "empty_centroids"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 3, 20, 4), (20_001, 40,
                                                            3000, 700)])
def test_rho_gather_nnz_equal_plain(dev, shape, case):
    """Rows limited by ``nnz``, with nonzero values and other ids past it:
    the live-values call's bits, the plain version's on the card and on
    the CPU, and the same bits on a second run (the centroid order within
    a bin is free); B not a multiple of the 8-document block."""
    ids, vals, nnz, means, assign, live = _rho_case(shape, case, seed=16)
    g = [x.to(dev) for x in (assign, ids, vals, means)]
    n_dev = nnz.to(dev)
    ops.reset_counts()
    got = ops.rho_gather(*g, nnz=n_dev)
    again = ops.rho_gather(*g, nnz=n_dev)
    assert ops.LAUNCHES["rho_gather"] == 2 and ops.PLAIN["rho_gather"] == 0
    assert torch.equal(got, again)
    assert torch.equal(got, ref.rho_gather(*g, nnz=n_dev))
    assert torch.equal(got, ops.rho_gather(g[0], g[1], live.to(dev), g[3]))
    assert torch.equal(got.cpu(), ref.rho_gather(assign, ids, vals, means,
                                                 nnz=nnz))
    out = (assign < 0) | (assign >= shape[3])
    assert bool((got.cpu()[out] == 0).all())


@pytest.mark.parametrize("shape", SHAPES)
def test_ta_gather_variant_equal_plain(dev, shape):
    """A different v_ta on every row, v_ta = 0 on some rows."""
    b = shape[0]
    ids, vals, means, _ = _inputs(*shape, seed=7)
    gen = torch.Generator().manual_seed(8)
    v_ta = torch.rand((b,), generator=gen) * 0.8
    v_ta[::3] = 0.0
    t_th = int(0.5 * shape[2])
    g = [x.to(dev) for x in (ids, vals, means)]
    ops.reset_counts()
    got = ops.esicp_gather(*g, t_th, 0.0, with_counts=True,
                           v_ta=v_ta.to(dev))
    want = ref.esicp_gather(*g, t_th, 0.0, with_counts=True,
                            v_ta=v_ta.to(dev))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert bool((got[1][::3] == 0).all())           # v_ta = 0: no Region 3
    assert ops.LAUNCHES["esicp_gather_ta"] == 1
    assert ops.LAUNCHES["esicp_gather"] == 0


@pytest.mark.parametrize("t_frac", [0.0, 0.6])
@pytest.mark.parametrize("shape", SHAPES)
def test_square_variant_equal_plain(dev, shape, t_frac):
    """The squared-rows launch on the document tile as CS-ICP passes it (1
    on the slots with id >= t_th): at t_th = 0 the dead slots (id 0) are
    live and the rows' ids do not ascend (walked slot by slot); at a t_th
    inside the ids only the tail counts.  Batches above a tile (4096, 37)
    and below it (9)."""
    ids, vals, means, _ = _inputs(*shape, seed=9)
    ones = (ids >= int(t_frac * shape[2])).to(torch.float32)
    g = [x.to(dev) for x in (ids, ones, means)]
    ops.reset_counts()
    got, none = ops.sparse_sim(*g, square=True)
    assert none is None
    assert ops.LAUNCHES["sparse_sim_square"] == 1
    assert ops.LAUNCHES["sparse_sim"] == 0
    assert torch.equal(got, ref.sparse_sim(*g, square=True)[0])
    assert torch.equal(got, ref.sparse_sim(g[0], g[1], g[2] * g[2])[0])
    with pytest.raises(ValueError, match="no counts"):
        ops.sparse_sim(*g, square=True, with_counts=True)


# (bh, sq, sk, hd, window, sk_real): tails of the 64-row and 32-key tiles
# (Sq and Sk not multiples of either, Sq 64 + 1 at hd 256), Sq != Sk with
# rows that see no key, windows smaller than a key tile, sk_real cutting a
# key tile, every head dim.
FLASH_SHAPES = [(2, 64, 64, 32, -1, None), (3, 200, 136, 64, 48, None),
                (4, 256, 256, 128, 48, None), (2, 300, 300, 256, -1, None),
                (2, 300, 300, 256, 100, None), (1, 37, 37, 16, 8, None),
                (2, 128, 128, 32, 20, 90), (2, 100, 150, 64, -1, None),
                (3, 130, 70, 128, -1, None), (2, 200, 200, 64, 5, None),
                (2, 97, 97, 16, 1, None), (2, 160, 160, 128, -1, 77),
                (2, 150, 150, 256, 40, 101), (2, 65, 65, 256, -1, None)]


@pytest.mark.parametrize("bh,sq,sk,hd,window,sk_real", FLASH_SHAPES)
def test_flash_attention_close_to_plain(dev, bh, sq, sk, hd, window, sk_real):
    """Max abs err 2e-5 (as tests/test_kernels.py holds the Pallas kernel);
    rows with no live key exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(bh * sq + hd)
    q, k, v = (torch.randn((bh, n, hd), generator=gen, device=dev)
               for n in (sq, sk, sk))
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, window=window, sk_real=sk_real)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.PLAIN["flash_attention"] == 0
    want = ref.flash_attention(q, k, v, window, sk_real)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.cpu(), ref.flash_attention(
        q.cpu(), k.cpu(), v.cpu(), window, sk_real), rtol=2e-5, atol=2e-5)
    live_keys = min(sk, sk if sk_real is None else sk_real)
    if window > 0 and sq >= live_keys + window:
        assert bool((got[:, live_keys + window - 1:] == 0).all())


@pytest.mark.parametrize("bh,s,hd,window", [(2, 300, 256, -1),
                                             (3, 200, 64, 48)])
def test_flash_attention_large_scores_close_to_plain(dev, bh, s, hd, window):
    """Scores of magnitude ≈ 30 (q, k scaled by 6): the online rescaling
    under the split-TF32 products stays within 2e-5 of the plain version
    evaluated in float64, and closer to it than the plain version in
    float32 (whose own error there, about 9e-5 at hd 256, exceeds 2e-5)."""
    gen = torch.Generator(device=dev).manual_seed(bh + s + hd)
    q, k, v = (torch.randn((bh, s, hd), generator=gen, device=dev)
               for _ in range(3))
    q, k = q * 6, k * 6
    got = ops.flash_attention(q, k, v, window=window)
    want = ref.flash_attention(q.double(), k.double(), v.double(), window)
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=2e-5)
    plain = ref.flash_attention(q, k, v, window).double()
    assert (got.double() - want).abs().max() <= (plain - want).abs().max()


def test_flash_attention_prefill_launches_once_per_layer(dev):
    from repro_torch.configs import gemma3_1b
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.lm import make_prefill_fn

    cfg = gemma3_1b.smoke_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 45), device=dev)
    ops.reset_counts()
    out = make_prefill_fn(cfg)(params, toks)
    torch.cuda.synchronize()
    assert out.shape == (2, cfg.vocab) and bool(torch.isfinite(out).all())
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.PLAIN["flash_attention"] == 0


def test_flash_attention_operands_the_kernel_cannot_take_raise(dev):
    q = torch.zeros((2, 40, 32), device=dev)
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            q, q)
    odd = torch.zeros((2, 40, 24), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(odd, odd, odd)
