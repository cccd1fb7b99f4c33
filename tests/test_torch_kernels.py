"""The five kernels' plain versions (the CPU path of kernels/ops.py)
against ``repro``: its jnp oracles (``repro.kernels.ref``) and its Pallas
kernels run in interpret mode (``repro.kernels.ops``), at tiny
block-aligned and non-aligned shapes.  The inputs hold dead slots (id 0,
value 0), rows assigned K (which select nothing) and duplicate ids within a
row.  Tolerances: 1e-5 for similarities, bound operands and ρ (float32 sums
in another order than the MXU's), 1e-4 for the cluster sums λ, exact for
masks and counts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.sparse.matrix import SparseDocs, term_major  # noqa: E402

# (B, P, D, K): non-aligned, then block-aligned (b_blk 128, d_blk 256).
SHAPES = [(20, 13, 300, 37), (128, 16, 512, 256)]


def _inputs(b, p, d, k, seed):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, p + 1, b)
    nnz[0] = 0                                      # an empty row
    ids = np.zeros((b, p), np.int32)
    vals = np.zeros((b, p), np.float32)
    for i in range(b):
        row = np.sort(rng.choice(d, nnz[i], replace=False))
        ids[i, :nnz[i]] = row
        vals[i, :nnz[i]] = rng.random(nnz[i]) + 0.05
    # duplicate ids within a row (both live) on a few rows
    for i in range(1, b, 5):
        if nnz[i] >= 2:
            ids[i, 1] = ids[i, 0]
    means = rng.random((d, k)).astype(np.float32)
    means[rng.random((d, k)) < 0.6] = 0.0           # sparse, like real means
    assign = rng.integers(0, k, b).astype(np.int32)
    assign[::4] = k                                  # rows that select nothing
    return ids, vals, means, assign


def _t(a):
    return torch.from_numpy(np.array(a))


def _docs(ids, vals, d):
    """SparseDocs of ``_inputs``' rows (live slots lead, values > 0)."""
    return SparseDocs(_t(ids), _t(vals),
                      _t((vals != 0).sum(axis=1).astype(np.int32)), d)


def _walk(tm, assign, k: int, d: int):
    """λ_t summed posting by posting over a term-major layout: each entry
    adds its postings in layout order, as the CUDA kernel does."""
    terms = torch.repeat_interleave(torch.arange(d), tm.ptr.diff())
    a = assign[tm.rows.long()]
    ok = (a >= 0) & (a < k)
    lam = torch.zeros(d * k)
    lam.index_add_(0, (terms * k + a.long())[ok], tm.vals[ok])
    return lam.view(d, k)


@pytest.mark.parametrize("shape", SHAPES)
def test_sparse_sim_plain_matches_repro(shape):
    ids, vals, means, _ = _inputs(*shape, seed=1)
    sims, counts = ref.sparse_sim(_t(ids), _t(vals), _t(means),
                                  with_counts=True)
    want = np.asarray(jref.sparse_sim(ids, vals, means))
    np.testing.assert_allclose(sims.numpy(), want, rtol=1e-5, atol=1e-5)
    p_sims, p_counts = jops.sparse_sim(ids, vals, means, diag=True,
                                       interpret=True)
    np.testing.assert_allclose(sims.numpy(), np.asarray(p_sims), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(p_counts).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_esicp_gather_plain_matches_repro(shape):
    ids, vals, means, _ = _inputs(*shape, seed=2)
    d = shape[2]
    t_th, v_th = int(0.6 * d), 0.5
    rho12, y, sims, counts = ref.esicp_gather(
        _t(ids), _t(vals), _t(means), t_th, v_th, with_counts=True)
    w_rho12, w_y = jref.esicp_gather(ids, vals, means, t_th, v_th)
    np.testing.assert_allclose(rho12.numpy(), np.asarray(w_rho12),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(w_y), rtol=1e-5,
                               atol=1e-5)
    p = jops.esicp_gather(ids, vals, means, jnp.int32(t_th),
                          jnp.float32(v_th), with_sims=True, diag=True,
                          interpret=True)
    for got, want in zip((rho12, y, sims), p[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(p[3]).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_esicp_filter_plain_matches_repro(shape):
    b, _, _, k = shape
    rng = np.random.default_rng(3)
    rho12 = rng.random((b, k)).astype(np.float32)
    y = rng.random((b, k)).astype(np.float32)
    rho_max = rng.random(b).astype(np.float32) * 1.5
    rho_max[0] = -np.inf                               # iteration-1 rows
    col_ok = rng.random((b, k)) < 0.7
    v_th = 0.3
    mask, count = ref.esicp_filter(_t(rho12), _t(y), _t(rho_max), _t(col_ok),
                                   v_th)
    w_mask, w_count = jref.esicp_filter(rho12, y, rho_max, col_ok, v_th)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(w_mask) != 0)
    np.testing.assert_array_equal(count.numpy(), np.asarray(w_count))
    p_mask, p_count = jops.esicp_filter(rho12, y, rho_max, col_ok,
                                        jnp.float32(v_th), interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(p_mask) != 0)
    np.testing.assert_array_equal(count.numpy(), np.asarray(p_count))


@pytest.mark.parametrize("shape", SHAPES)
def test_segment_update_plain_matches_repro(shape):
    b, _, d, k = shape
    ids, vals, _, assign = _inputs(*shape, seed=4)
    lam_t = ref.segment_update(_t(assign), _t(ids), _t(vals), k, d)
    assert lam_t.shape == (d, k)
    want = np.asarray(jref.segment_update(assign, ids, vals, k, d))
    np.testing.assert_allclose(lam_t.numpy().T, want, rtol=1e-4, atol=1e-4)
    p = jops.segment_update(assign, ids, vals, k=k, d=d, interpret=True)
    np.testing.assert_allclose(lam_t.numpy().T, np.asarray(p), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_rho_gather_plain_matches_repro(shape):
    ids, vals, means, assign = _inputs(*shape, seed=5)
    rho = ref.rho_gather(_t(assign), _t(ids), _t(vals), _t(means))
    want = np.asarray(jref.rho_gather(assign, ids, vals, means))
    np.testing.assert_allclose(rho.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (rho.numpy()[::4] == 0).all()             # assign = K reads 0
    p = jops.rho_gather(assign, ids, vals, means, interpret=True)
    np.testing.assert_allclose(rho.numpy(), np.asarray(p), rtol=1e-5,
                               atol=1e-5)


def _dirty(ids, vals, seed):
    """(ids, vals, nnz) with nonzero values and other ids past each row's
    nnz: what a row of ``_inputs`` holds in its live slots, garbage
    after."""
    rng = np.random.default_rng(seed)
    nnz = (vals != 0).sum(axis=1).astype(np.int32)
    past = np.arange(ids.shape[1])[None, :] >= nnz[:, None]
    d_ids = np.where(past, rng.integers(0, ids.max() + 1, ids.shape),
                     ids).astype(np.int32)
    d_vals = np.where(past, rng.random(vals.shape) + 0.5,
                      vals).astype(np.float32)
    return d_ids, d_vals, nnz


@pytest.mark.parametrize("shape", SHAPES)
def test_rho_gather_nnz_equals_live_vals(shape):
    """With ``nnz`` the plain version reads only each row's first nnz
    slots: the bits of the call on the live values (``live_vals``, what
    the update passed before), whatever lies past nnz, and repro's ρ
    within 1e-5."""
    ids, vals, means, assign = _inputs(*shape, seed=13)
    d_ids, d_vals, nnz = _dirty(ids, vals, seed=14)
    docs = SparseDocs(_t(d_ids), _t(d_vals), _t(nnz), shape[2])
    assert not torch.equal(docs.live_vals(), docs.vals)
    got = ref.rho_gather(_t(assign), docs.ids, docs.vals, _t(means),
                         nnz=docs.nnz)
    want = ref.rho_gather(_t(assign), _t(ids), docs.live_vals(), _t(means))
    assert torch.equal(got, want)
    assert not torch.equal(got, ref.rho_gather(_t(assign), docs.ids,
                                               docs.vals, _t(means)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.rho_gather(assign, ids, vals, means)),
        rtol=1e-5, atol=1e-5)
    ops.reset_counts()
    assert torch.equal(ops.rho_gather(_t(assign), docs.ids, docs.vals,
                                      _t(means), nnz=docs.nnz), got)
    assert ops.PLAIN["rho_gather"] == 1 and ops.LAUNCHES["rho_gather"] == 0
    ops.reset_counts()


@pytest.mark.parametrize("bad,err,match", [
    (lambda n: n.long(), TypeError, "nnz must be"),
    (lambda n: n[:-1], ValueError, "one entry per row"),
    (lambda n: n[:, None], ValueError, "nnz must have 1 dims"),
    (lambda n: torch.empty(n.shape, dtype=n.dtype, device="meta"),
     ValueError, "several devices")])
def test_rho_gather_rejects_bad_nnz(bad, err, match):
    ids, vals, means, assign = _inputs(8, 4, 30, 5, seed=15)
    nnz = _t((vals != 0).sum(axis=1).astype(np.int32))
    with pytest.raises(err, match=match):
        ops.rho_gather(_t(assign), _t(ids), _t(vals), _t(means),
                       nnz=bad(nnz))


def test_segment_update_sums_in_row_order():
    """λ is repro's scatter bit for bit: each entry sums its rows in order."""
    ids, vals, _, assign = _inputs(64, 10, 50, 6, seed=6)
    lam_t = ref.segment_update(_t(assign), _t(ids), _t(vals), 6, 50)
    want = np.asarray(jnp.zeros((6, 50), jnp.float32)
                      .at[assign[:, None], ids].add(vals))
    np.testing.assert_array_equal(lam_t.numpy().T, want)


# (B, P, D, K): the kernel shapes, and a vocabulary most of whose terms no
# row uses.
TERM_SHAPES = SHAPES + [(7, 5, 1000, 3)]


@pytest.mark.parametrize("shape", TERM_SHAPES)
def test_term_major_keeps_row_slot_order(shape):
    """Each term's postings are its live tuples in (row, slot) order (a
    duplicate id within a row twice, in slot order); dead slots, empty
    rows and zero values inside a row are dropped; unused terms have empty
    ranges; ``order`` ranks the terms by posting count, longest first."""
    b, p, d, _ = shape
    ids, vals, _, _ = _inputs(*shape, seed=10)
    vals[2, 0] = 0.0                      # a zero value inside a live row
    tm = term_major(_t(ids), _t(vals), d=d)
    want = [[] for _ in range(d)]
    for r in range(b):
        for q in range(p):
            if vals[r, q] != 0:
                want[ids[r, q]].append((r, vals[r, q]))
    ptr = tm.ptr.numpy()
    assert tm.ptr.dtype == torch.int64 and ptr.shape == (d + 1,)
    assert tm.rows.dtype == torch.int32 and tm.vals.dtype == torch.float32
    assert ptr[0] == 0 and ptr[-1] == sum(map(len, want))
    for t in range(d):
        got = list(zip(tm.rows[ptr[t]:ptr[t + 1]].tolist(),
                       tm.vals[ptr[t]:ptr[t + 1]].tolist()))
        assert got == [(r, float(v)) for r, v in want[t]], t
    assert any(len(w) == 0 for w in want)           # unused terms
    assert any(len(w) > len(set(r for r, _ in w)) for w in want)  # dups
    counts = np.diff(ptr)
    order = tm.order.numpy()
    assert tm.order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(d))
    assert (np.diff(counts[order]) <= 0).all()


@pytest.mark.parametrize("shape", TERM_SHAPES)
def test_segment_update_by_term_equals_row_major(shape):
    """The documents' term-major layout summed posting by posting (the
    kernel's order) gives the CPU call's bits (the row-major plain
    version) and repro's scatter's, assignments outside [0, K) included;
    the CPU call never builds the layout."""
    b, _, d, k = shape
    ids, vals, _, assign = _inputs(*shape, seed=11)
    assign[1::7] = -1
    dropped = np.where(assign < 0, k, assign)      # jnp would wrap -1
    want = np.asarray(jnp.zeros((k, d), jnp.float32)
                      .at[dropped[:, None], ids].add(vals))
    docs, ta = _docs(ids, vals, d), _t(assign)
    ops.reset_counts()
    got = ops.segment_update(ta, docs, k=k)
    assert ops.PLAIN["segment_update"] == 1
    assert ops.LAUNCHES["segment_update"] == 0
    assert "by_term" not in vars(docs)
    assert torch.equal(_walk(docs.by_term, ta, k, d), got)
    np.testing.assert_array_equal(got.numpy().T, want)


def test_segment_update_by_term_validated():
    """The layout is the documents' own: built once, from their live
    tuples only (values past a row's nnz are ignored)."""
    ids, vals, _, assign = _inputs(8, 4, 30, 5, seed=12)
    docs = _docs(ids, vals, 30)
    stale = np.where(vals == 0, 7.0, vals).astype(np.float32)
    dirty = SparseDocs(_t(ids), _t(stale), docs.nnz, 30)
    assert dirty.by_term is dirty.by_term
    assert dirty.to("cpu") is dirty                  # keeps its layout
    for got, want in zip(dirty.by_term, docs.by_term):
        assert torch.equal(got, want)
    assert torch.equal(ops.segment_update(_t(assign), dirty, k=5),
                       ops.segment_update(_t(assign), docs, k=5))
    with pytest.raises(ValueError, match="one entry per row"):
        ops.segment_update(_t(assign)[:3], docs, k=5)


def _tile_plan(ids, vals, d: int, bt: int):
    """The tiled gather's plan, plainly: per tile of ``bt`` rows its
    distinct live ids ascending, each head slot's index into them (-1
    elsewhere) and the slot from which each row is walked slot by slot.  A
    row's head is its live slots up to the last with an id other than 0;
    when the head's ids ascend, the tile adds it and the walk takes the
    live id-0 slots after it (from P: none), else the walk takes the row."""
    b, p = ids.shape
    live = (vals != 0) & (ids >= 0) & (ids < d)
    pos = torch.arange(p).expand(b, p)
    last = torch.where(live & (ids != 0), pos, -1).max(dim=1).values
    head = live & (pos <= last[:, None])
    big = torch.iinfo(torch.int64).min
    prev = torch.cummax(torch.where(head, ids.long(), big), dim=1).values
    prev = torch.nn.functional.pad(prev, (1, 0), value=big)[:, :-1]
    ordered = ~(head & (ids.long() < prev)).any(dim=1)
    after = (live & (pos > last[:, None])).any(dim=1)
    walk = torch.where(ordered, torch.where(after, last + 1, p), 0)
    index = torch.full(ids.shape, -1, dtype=torch.int64)
    tiles = []
    for t0 in range(0, b, bt):
        sl = slice(t0, t0 + bt)
        uid = torch.unique(ids[sl][live[sl]].long())       # sorted
        index[sl] = torch.where(head[sl] & ordered[sl, None],
                                torch.searchsorted(uid, ids[sl].long()), -1)
        tiles.append((t0, uid))
    return tiles, index, walk


def _merged_gather(ids, vals, means, d: int, bt: int, t_th=None, thr=None,
                   square=False):
    """sims [, rho12, y] and counts summed in the tiled kernel's order: per
    tile, the (distinct id, slot) pairs ascending; over the head
    (float(id) < t_th) one accumulator, copied into rho12 where the tile's
    ids cross t_th; each row's slots from its walk on slot by slot after.
    ``square``: each slot adds v·(m·m)."""
    tiles, index, walk = _tile_plan(ids, vals, d, bt)
    b, p = ids.shape
    k = means.shape[1]
    acc, rho, y = (torch.zeros((b, k)) for _ in range(3))
    cnt = torch.zeros((b, k), dtype=torch.int32)

    def add(r, q, tail, walk=False):
        """One tuple; ``walk``: slot order, rho12 has no copy to start
        from, so the head adds to it too."""
        v, m = vals[r, q], means[ids[r, q]]
        c = v * (m * m) if square else v * m
        acc[r] += c
        if walk and t_th is not None and not tail:
            rho[r] += c
            cnt[r] += (m > 0).to(torch.int32)
        elif tail:
            exact = m >= thr[r]
            rho[r] += torch.where(exact, c, 0.0)
            y[r] += torch.where(exact, 0.0, v)
            cnt[r] += (exact & (m > 0)).to(torch.int32)
        else:
            cnt[r] += (m > 0).to(torch.int32)

    for t0, uid in tiles:
        rows = range(t0, min(t0 + bt, b))
        u_th = (len(uid) if t_th is None else
                int((uid.to(torch.float32) < t_th).sum()))
        pairs = sorted((int(index[r, q]), q, r) for r in rows for q in range(p)
                       if index[r, q] >= 0)
        crossed = False
        for u, q, r in pairs:
            if u >= u_th and not crossed:
                rho[t0:t0 + bt] = acc[t0:t0 + bt]
                crossed = True
            add(r, q, u >= u_th)
        if not crossed:
            rho[t0:t0 + bt] = acc[t0:t0 + bt]
        live = (vals != 0) & (ids >= 0) & (ids < d)
        for r in rows:
            for q in range(int(walk[r]), p):
                if live[r, q]:
                    add(r, q, t_th is not None
                        and float(ids[r, q].to(torch.float32)) >= t_th,
                        walk=True)
    return acc, rho, y, cnt


@pytest.mark.parametrize("bt", [1, 4, 64])
@pytest.mark.parametrize("t_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("square", [False, True])
def test_tiled_gather_order_equals_plain(bt, t_frac, square):
    """The tiled gather's order argument: a row's live ids ascend, so
    visiting its tile's distinct ids in ascending order visits its slots in
    slot order (duplicate ids included), and the head's single accumulator
    copied at t_th is rho12 — bit for bit the plain versions, with dead
    slots, empty rows, a zero value inside a row, t_th at 0, inside and at
    D, per-row thresholds, and rows whose ids do not ascend (walked slot by
    slot).  ``square``: the square mode as CS-ICP calls it (1 on the slots
    with id >= t_th) gives the plain version's sums of v·m² bit for bit and
    ``repro``'s sparse_sim over the squared means to rounding; at t_th 0
    the dead id-0 slots at the end of a row are live, so the tile adds each
    row's head and the walk its id-0 slots after."""
    if square:
        _check_square_order(bt, int(t_frac * 300))
    else:
        _check_gather_order(bt, int(t_frac * 300))


def _check_gather_order(bt: int, t_th: int):
    ids, vals, means, _ = _inputs(20, 13, 300, 37, seed=13)
    vals[2, 0] = 0.0
    ids, vals, means = _t(ids), _t(vals), _t(means)
    rev = ids[5].clone()
    ids[5, :int((vals[5] != 0).sum())] = rev[:int((vals[5] != 0).sum())].flip(0)
    d = 300
    _, _, walk = _tile_plan(ids, vals, d, bt)
    assert int(walk[5]) == 0 and bool((walk[:5] == 13).all())
    sims, counts = ref.sparse_sim(ids, vals, means, with_counts=True)
    got = _merged_gather(ids, vals, means, d, bt)
    assert torch.equal(got[0], sims) and torch.equal(got[3], counts)
    v_ta = torch.from_numpy(np.random.default_rng(14).random(20)
                            .astype(np.float32)) * 0.8
    for thr in (torch.full((20,), 0.5), v_ta):
        want = ref.esicp_gather(ids, vals, means, t_th, 0.5,
                                with_counts=True,
                                v_ta=None if thr is not v_ta else v_ta)
        got = _merged_gather(ids, vals, means, d, bt, t_th=t_th, thr=thr)
        for g, w in zip((got[1], got[2], got[0], got[3]), want):
            assert torch.equal(g, w)


def _check_square_order(bt: int, t_th: int):
    ids, _, means, _ = _inputs(20, 13, 300, 37, seed=15)
    d = 300
    ones = (ids >= t_th).astype(np.float32)
    ti, tv, tm = _t(ids), _t(ones), _t(means)
    _, _, walk = _tile_plan(ti, tv, d, bt)
    if t_th == 0:      # every slot live: the head ends at the last id != 0
        nz = ids != 0
        last = np.where(nz.any(axis=1), 12 - np.argmax(nz[:, ::-1], axis=1),
                        -1)
        want = np.where(last + 1 < 13, last + 1, 13)
        assert torch.equal(walk, _t(want.astype(np.int64)))
        assert (want < 13).any() and (want > 0).any()
    else:
        assert bool((walk == 13).all())
    want = ref.sparse_sim(ti, tv, tm, square=True)[0]
    got = _merged_gather(ti, tv, tm, d, bt, square=True)
    assert torch.equal(got[0], want)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jref.sparse_sim(ids, ones, means * means)),
        rtol=1e-5, atol=1e-6)


def test_ops_dispatch_cpu_to_plain_versions():
    """CPU operands go to the plain versions and count there; nothing
    launches."""
    ids, vals, means, assign = _inputs(20, 13, 300, 37, seed=7)
    ti, tv, tm, ta = _t(ids), _t(vals), _t(means), _t(assign)
    ops.reset_counts()
    ops.sparse_sim(ti, tv, tm)
    r12, y, _, _ = ops.esicp_gather(ti, tv, tm, 100, 0.5, with_counts=True)
    ops.esicp_filter(r12, y, torch.zeros(20), torch.ones((20, 37),
                                                         dtype=torch.bool),
                     0.5)
    ops.segment_update(ta, _docs(ids, vals, 300), k=37)
    ops.rho_gather(ta, ti, tv, tm)
    ops.esicp_gather(ti, tv, tm, 100, 0.5, v_ta=torch.full((20,), 0.3))
    ops.sparse_sim(ti, tv, tm, square=True)
    sk = ops.doc_sketch(ti, tv, 300, 60)
    ops.sketch_sim(sk, torch.ones((60, 37)))
    qkv = torch.ones((2, 5, 16))
    ops.flash_attention(qkv, qkv, qkv, window=3)
    assert ops.PLAIN == dict.fromkeys(ops.KERNELS, 1)
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)
    ops.reset_counts()


def test_ops_validate_operands():
    ids, vals, means, assign = _inputs(8, 4, 30, 5, seed=8)
    with pytest.raises(TypeError, match="ids must be"):
        ops.sparse_sim(_t(ids).long(), _t(vals), _t(means))
    with pytest.raises(TypeError, match="means_t must be"):
        ops.rho_gather(_t(assign), _t(ids), _t(vals), _t(means).double())
    with pytest.raises(ValueError, match="one entry per row"):
        ops.segment_update(_t(assign)[:3], _docs(ids, vals, 30), k=5)
