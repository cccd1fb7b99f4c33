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
shared-memory column tile and a term with 12,000 postings, and its
accumulating (``init``) launch chunk after chunk; for sketch_sim
tiles whose leading s are all zero; for rho_gather every row width up to
32 slots (the fused multiply-add orders); for the routed scan (grouped
by cell on the card) a cell taking every row and cells taking none,
cells wider than a column strip, B * n_probe not a multiple of the tile,
ties within a cell and across probe ranks, duplicate ids, rows
ascending or not, long rows and dead rows, empty cells (rows that probe
only empty ones) and a cell wider than cmax, both column paths (four
columns a thread, one), and a graph replay.  Kernel
and plain version add in the same order, without fused multiply-adds but
where ``repro`` has them (rho_gather's rows of at most 32 slots), so they
must agree bit for bit;
the plain segment_update on the card uses atomics (``index_add_``), so λ is
compared bitwise against the CPU plain version instead.  Beside the
kernels: the chunk prefetcher on the card (pinned ring of depth 1 and 3,
side stream, memory and memmapped stores) and a four-chunk streaming fit
against the resident fit, the two-level fit, routed classify and
routed serving against the CPU, and the mesh runtime: a world of one on
the card against ``lloyd_fit`` in its six modes (λ in spans, so the
accumulating launch runs), and two spawned gloo ranks sharing the card
at (1, 2) and (2, 1); and the LM path: flash_attention at head dims it
pads (12, 96, 200), each attention-family smoke config on the card
against the CPU in float32 (prefill logits, greedy tokens, with a
frontend prefix for musicgen and chameleon) and the int8 KV cache; the
sLSTM scan against its plain version bit for bit (xlstm-125m's prefill
and decode widths, D not a multiple of 32, gates × 10, a state carried
over two launches; at the ring's edges S = T - 1, T, T + 1, 3T + 5 for
the kernel's tile of T steps, and 16,384; the last S of the short-scan
walk and the first of the tiles; D not a multiple of the
channel group, B·D below one group, D not a multiple of 4 and gates off
16-byte alignment, both copied 4 bytes at a time), its backward bit for
bit against the plain reverse loop (the walk's last S and the tiles'
first, a tile and three tiles plus a step, D not a multiple of the
block's channels with 16- and 4-byte copies, ties at step 0 from a cached
state; two runs the same, adjoints carried over two launches) and
the two SSM smoke configs (xlstm, zamba2) on the card against the CPU.
This file imports neither JAX nor ``repro``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.slstm_scan import (  # noqa: E402
    BWD_CHANNELS, BWD_TILE, BWD_WALK_BELOW, TILE as SLSTM_TILE,
    WALK_BELOW as SLSTM_WALK)

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
    full = torch.full((shape[0],), shape[1], dtype=torch.int32)
    g = [x.to(dev) for x in (assign, ids, vals, means, full)]
    got = ops.rho_gather(*g)
    assert torch.equal(got, ref.rho_gather(*g))
    assert torch.equal(got.cpu(), ref.rho_gather(assign, ids, vals, means,
                                                 full))
    assert bool((got[::5] == 0).all()) and bool((got[1::7] == 0).all())


@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("p", range(1, 33))
def test_rho_gather_short_rows_equal_plain(dev, p, k):
    """Rows of at most 32 slots take XLA's order of fused multiply-adds
    (``ref.short_row_stages``, K = 1 sequential up to 21 slots): the
    kernel's ``__fmaf_rn`` steps equal the plain version's exact fused
    multiply-adds bit for bit, on the card and on the CPU."""
    ids, vals, nnz, means, assign, _ = _rho_case((300, p, 500, k), "drawn",
                                                 seed=p)
    g = [x.to(dev) for x in (assign, ids, vals, means, nnz)]
    got = ops.rho_gather(*g)
    assert torch.equal(got, ref.rho_gather(*g))
    assert torch.equal(got.cpu(), ref.rho_gather(assign, ids, vals, means,
                                                 nnz))


def _routed_case(b, p, d, sizes, n_probe, seed, kind="random"):
    """(ids, vals, nnz, means_t, cells, starts, sizes, cmax): rows with
    garbage past nnz and a few dead ones, cells drawn without repeats,
    cell 1 a copy of cell 0's first columns (ties across cells).

    ``kind``: ``random`` (ids drawn with repeats, in no order);
    ``one_cell`` (cell 2 first for every row, so the other cells take no
    row at rank 0); ``ties`` (small integers in means and values: exact
    sums, equal values within a cell and across probe ranks);
    ``ascending`` (each row's live ids ascending, with duplicates);
    ``dead`` (every row nnz 0 or all its values 0); ``empty`` (the odd
    cells of size 0, every seventh row probing only those, and cmax 3
    below the largest size, whose slots past cmax are not scored)."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    if kind == "empty":
        sizes[1::2] = 0
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    k = int(sizes.sum())
    if kind == "ties":
        means = rng.integers(0, 3, (d, k)).astype(np.float32)
    else:
        means = rng.random((d, k)).astype(np.float32)
    means[rng.random((d, k)) < 0.5] = 0.0
    means[:, starts[1]:starts[1] + sizes[1]] = means[:, :sizes[1]]
    nnz = rng.integers(0, p + 1, b).astype(np.int32)
    nnz[::17] = 0
    ids = rng.integers(0, d, (b, p)).astype(np.int32)
    if kind == "ascending":
        ids = np.sort(rng.integers(0, max(d // 8, 1), (b, p)), axis=1)
        ids = ids.astype(np.int32)
    if kind == "ties":
        vals = rng.integers(1, 3, (b, p)).astype(np.float32)
    else:
        vals = (rng.random((b, p)) + 0.05).astype(np.float32)
    vals[rng.random((b, p)) < 0.1] = 0.0
    if kind == "dead":
        nnz[::2] = 0
        vals[1::2] = 0.0
    cells = np.stack([rng.permutation(len(sizes))[:n_probe]
                      for _ in range(b)]).astype(np.int32)
    cells[1::5, :min(n_probe, 2)] = [1, 0][:min(n_probe, 2)]
    if kind == "one_cell":
        for row in cells:
            row[:] = np.concatenate([[2], np.delete(row, row == 2)])[:n_probe]
    if kind == "empty":
        cells[::7] = np.arange(1, len(sizes), 2)[:n_probe]
    t = torch.from_numpy
    return (t(ids), t(vals), t(nnz), t(means), t(cells), t(starts),
            t(sizes), int(sizes.max()) - (3 if kind == "empty" else 0))


def _hold_routed(dev, case, got):
    """``got`` against the plain version on the card and on the CPU, bit
    for bit, and each winner's similarity against the flat
    ``sparse_sim`` for its column (rows without a live candidate, column
    0 at -inf, aside)."""
    g = [x.to(dev) for x in case[:7]]
    want = ref.routed_scan(*g, case[7])
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    cpu = ref.routed_scan(*case)
    for a, w in zip(got, cpu):
        assert torch.equal(a.cpu(), w)
    ids, vals, nnz = case[0], case[1], case[2]
    live = torch.arange(ids.shape[1])[None, :] < nnz[:, None]
    flat = ref.sparse_sim(torch.where(live, ids, 0).to(dev),
                          torch.where(live, vals, 0.0).to(dev), g[3])[0]
    won = torch.isfinite(got[1])
    assert torch.equal(got[1][won],
                       flat.gather(1, got[0].long()[:, None])[:, 0][won])


@pytest.mark.parametrize("b,p,d,sizes,n_probe,kind", [
    (300, 60, 2000, [40, 7, 1, 300, 90], 2, "random"),
    (64, 1300, 5000, [3, 3, 1, 2], 4, "random"),
    (9, 5, 50, [1, 1, 1], 1, "random"),
    (2000, 200, 30000, [120] * 30 + [1, 400], 3, "random"),
    (1000, 80, 3000, [33, 17, 64, 5, 9, 70], 1, "one_cell"),
    (1000, 80, 3000, [33, 17, 64, 5, 9, 70], 3, "one_cell"),
    (301, 40, 3000, [20, 700, 1, 129, 256, 257], 3, "random"),
    (301, 50, 400, [32, 32, 31, 96, 8], 3, "ties"),
    (500, 70, 60, [64, 64, 3, 40], 4, "ties"),
    (777, 120, 3000, [50, 50, 200, 7], 2, "ascending"),
    (203, 30, 500, [10, 10, 40, 1], 2, "dead"),
    (512, 90, 3000, [36, 4, 300, 128, 64, 8], 2, "random"),
    (301, 50, 400, [32, 32, 28, 96, 8], 3, "ties"),
    (777, 120, 3000, [52, 48, 200, 8], 2, "ascending"),
    (400, 60, 2000, [30, 5, 40, 9, 12, 7], 3, "empty"),
    (400, 60, 2000, [32, 5, 40, 9, 12, 7], 1, "empty"),
])
def test_routed_scan_equal_plain(dev, b, p, d, sizes, n_probe, kind):
    """The routed scan against its plain version bit for bit: cells that
    take every row or none, cells wider than a block's column strip
    (the 700-wide one more than twice the widest), B * n_probe not a
    multiple of the tile, rows past 128 staged slots, single-centroid
    cells, ties within a cell and across probe ranks (the lower rank,
    then the lower slot wins), duplicate ids, rows ascending or in no
    order, dead rows, garbage past nnz, empty cells and rows probing only
    those (column 0 at -inf), a cell wider than cmax, K a multiple of 4
    (four columns a thread, 16-byte gathers) or not (one); and each
    winner's similarity is the flat ``sparse_sim``'s for its column."""
    case = _routed_case(b, p, d, sizes, n_probe, seed=b,
                        kind=kind)
    g = [x.to(dev) for x in case[:7]]
    ops.reset_counts()
    got = ops.routed_scan(*g, case[7])
    assert ops.LAUNCHES["routed_scan"] == 1 and ops.PLAIN["routed_scan"] == 0
    _hold_routed(dev, case, got)
    if kind == "dead":
        assert bool((got[1] == 0).all())
    if kind == "empty":
        assert bool((got[1][::7] == -torch.inf).all())
        assert bool((got[0][::7] == 0).all())


@pytest.mark.parametrize("four", [True, False])
@pytest.mark.parametrize("n_probe,kind", [(1, "one_cell"), (3, "random"),
                                          (4, "ties")])
def test_routed_scan_column_paths_equal_plain(dev, four, n_probe, kind):
    """Both column paths of ``csrc/routed_scan.cu`` on the same work (K
    540): four columns a thread on ``means_t`` as it comes, one column a
    thread on a copy 4 bytes past a 16-byte boundary; bit for bit against
    the plain version, and the same call in a CUDA graph replayed on
    other rows."""
    case = _routed_case(203, 90, 3000, [40, 1, 300, 129, 64, 6], n_probe,
                        seed=n_probe, kind=kind)
    g = [x.to(dev) for x in case[:7]]
    if not four:
        means = g[3]
        g[3] = torch.empty((means.numel() + 1,), dtype=torch.float32,
                           device=dev)[1:].view(means.shape)
        g[3].copy_(means)
        assert g[3].data_ptr() % 16 == 4
    ops.reset_counts()
    _hold_routed(dev, case, ops.routed_scan(*g, case[7]))
    assert ops.LAUNCHES["routed_scan"] == 1 and ops.PLAIN["routed_scan"] == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.routed_scan(*g, case[7])
    other = _routed_case(203, 90, 3000, [40, 1, 300, 129, 64, 6], n_probe,
                         seed=n_probe + 100, kind=kind)
    for x, y in zip(g, other[:7]):
        x.copy_(y)
    graph.replay()
    torch.cuda.synchronize()
    _hold_routed(dev, other, out)


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
                                                            3000, 700),
                                   (300, 1100, 3000, 50),
                                   (40, 5000, 8000, 9), (64, 32, 500, 7)])
def test_rho_gather_nnz_equal_plain(dev, shape, case):
    """Rows limited by ``nnz``, with nonzero values and other ids past it:
    the live-values call's bits, the plain version's on the card and on
    the CPU, and the same bits on a second run (the centroid order within
    a bin is free); B not a multiple of the 8-document block; rows of at
    most 32 slots (one window), of 1100 and 5000 (two window levels)."""
    ids, vals, nnz, means, assign, live = _rho_case(shape, case, seed=16)
    g = [x.to(dev) for x in (assign, ids, vals, means)]
    n_dev = nnz.to(dev)
    ops.reset_counts()
    got = ops.rho_gather(*g, nnz=n_dev)
    again = ops.rho_gather(*g, nnz=n_dev)
    assert ops.LAUNCHES["rho_gather"] == 2 and ops.PLAIN["rho_gather"] == 0
    assert torch.equal(got, again)
    assert torch.equal(got, ref.rho_gather(*g, nnz=n_dev))
    full = torch.full_like(n_dev, shape[1])
    assert torch.equal(got, ops.rho_gather(g[0], g[1], live.to(dev), g[3],
                                           full))
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
    wide = torch.zeros((2, 40, 264), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(wide, wide, wide)


@pytest.mark.parametrize("hd", [12, 80, 96, 200])
@pytest.mark.parametrize("window", [-1, 48])
def test_flash_attention_pads_any_head_dim(dev, hd, window):
    """A head dim without an instantiation runs on the next one, zero
    columns added and sliced off, scaled by 1/sqrt(hd): within 2e-5 of
    the plain version at hd (granite's smoke config has hd 12, zamba2-2.7b
    hd 80)."""
    gen = torch.Generator(device=dev).manual_seed(hd + window)
    q, k, v = (torch.randn((3, 150, hd), generator=gen, device=dev)
               for _ in range(3))
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.PLAIN["flash_attention"] == 0
    assert got.shape == (3, 150, hd) and got.is_contiguous()
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, window),
                               rtol=2e-5, atol=2e-5)


SMOKE_ARCHS = ["gemma-2b", "qwen1.5-32b", "qwen2.5-32b",
               "granite-moe-3b-a800m", "mixtral-8x22b", "musicgen-large",
               "chameleon-34b"]


def _smoke_pair(arch, dev, **change):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models.transformer import init_params, tree_to

    cfg = dataclasses.replace(registry.smoke_config(arch), **change)
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    return cfg, {"cpu": params, "cuda": tree_to(params, dev)}


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_archs_on_card_equal_cpu(dev, arch):
    """Float32 on both: prefill logits (a frontend prefix for musicgen and
    chameleon) within 1e-4 and identical greedy tokens; the card launched
    the kernel once per layer and ran no plain version."""
    from repro_torch.serve.lm import ServeLoop, make_prefill_fn

    cfg, params = _smoke_pair(arch, dev)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=gen)
    fe = (torch.randn((2, 5, cfg.d_model), generator=gen)
          if cfg.modality != "text" else None)
    f32 = torch.float32
    lg, out = {}, {}
    for where in ("cuda", "cpu"):
        ops.reset_counts()
        lg[where] = make_prefill_fn(cfg, compute_dtype=f32)(
            params[where], toks.to(where),
            None if fe is None else fe.to(where))
        if where == "cuda":
            torch.cuda.synchronize()
            assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
            assert ops.PLAIN["flash_attention"] == 0
        out[where] = ServeLoop(cfg, params[where], max_len=32,
                               compute_dtype=f32).generate(
            toks[:, :8].to(where), n_new=16)
    torch.testing.assert_close(lg["cuda"].cpu(), lg["cpu"], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "granite-moe-3b-a800m",
                                  "mixtral-8x22b"])
def test_int8_decode_on_card_equals_cpu(dev, arch):
    """The int8 cache, float32 compute: decode logits within 1e-4, the
    cache's scales within rtol 1e-5 (the keys and values themselves come
    from float32 products summed in another order on the card) and its
    codes within 1 (rounded apart at a half-integer), greedy tokens
    identical."""
    from repro_torch.models.transformer import decode_forward, init_cache
    from repro_torch.serve.lm import ServeLoop

    cfg, params = _smoke_pair(arch, dev, kv_dtype="int8")
    f32 = torch.float32
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(4))
    caches = {w: init_cache(cfg, 2, 24, device=w, compute_dtype=f32)
              for w in ("cuda", "cpu")}
    for pos in range(20):
        lg = {w: decode_forward(params[w], caches[w], toks[:, pos:pos + 1].to(w),
                                pos, cfg, compute_dtype=f32)[0]
              for w in ("cuda", "cpu")}
        torch.testing.assert_close(lg["cuda"].cpu(), lg["cpu"], rtol=1e-4,
                                   atol=1e-4)
    for got, want in zip(caches["cuda"], caches["cpu"]):
        for name in ("k", "v"):
            assert got[name]["q"].dtype == torch.int8
            codes = (got[name]["q"].cpu().int() - want[name]["q"].int()).abs()
            assert int(codes.max()) <= 1
            torch.testing.assert_close(got[name]["s"].cpu(), want[name]["s"],
                                       rtol=1e-5, atol=0)
    out = {w: ServeLoop(cfg, params[w], max_len=32, compute_dtype=f32).generate(
        toks[:, :8].to(w), n_new=16) for w in ("cuda", "cpu")}
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.parametrize("shape", SEGMENT_SHAPES)
def test_segment_update_init_bitwise(dev, shape):
    """The accumulating launch: bit for bit against the CPU plain version
    on the same init; the rows of terms without a posting left
    byte-identical; four chunks, one launch each, equal to one launch over
    the whole corpus.  The shapes give its terms long posting lists (the
    tile kernel), short ones (a warp a term) and both in one launch."""
    from repro_torch.sparse.matrix import SparseDocs

    b, _, d, k = shape
    ids, vals, _, assign = _inputs(*shape, seed=9)
    ids = torch.remainder(ids, d - 16)        # the last 16 terms unused
    if b >= 4096:     # term 0 in every row: a long posting list per chunk
        ids[:, 0] = 0
        vals[:, 0] = 0.25
    nnz = (vals != 0).sum(dim=1, dtype=torch.int32)
    rng = np.random.default_rng(10)
    init = torch.from_numpy(rng.standard_normal((d, k)).astype(np.float32))
    init[0, :1] = -0.0                                  # a signed zero
    docs = SparseDocs(ids.to(dev), vals.to(dev), nnz.to(dev), d)
    g = assign.to(dev)
    ops.reset_counts()
    got = ops.segment_update(g, docs, k=k, init=init.to(dev))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_update_init"] == 1
    assert ops.PLAIN["segment_update_init"] == 0
    want = ref.segment_update(assign, ids, vals, k, d, init=init.clone())
    assert torch.equal(got.cpu(), want)
    untouched = ~torch.bincount(ids[vals != 0].long(), minlength=d).bool()
    assert torch.equal(got.cpu()[untouched].view(torch.int32),
                       init[untouched].view(torch.int32))
    assert bool(untouched[-16:].all())
    # chunk after chunk == one launch over the whole corpus
    whole = ops.segment_update(g, docs, k=k)
    lam = None
    step = -(-b // 4)
    for s in range(0, b, step):
        part = docs.slice_rows(s, step)
        part = SparseDocs(part.ids.contiguous(), part.vals.contiguous(),
                          part.nnz.contiguous(), d)
        lam = ops.segment_update(g[s:s + part.n_docs].contiguous(), part,
                                 k=k, init=lam)
    torch.cuda.synchronize()
    assert torch.equal(lam, whole)


def test_segment_update_init_operands(dev):
    from repro_torch.sparse.matrix import SparseDocs

    ids, vals, _, assign = _inputs(9, 5, 50, 3, seed=11)
    docs = SparseDocs(ids.to(dev), vals.to(dev),
                      (vals != 0).sum(1, dtype=torch.int32).to(dev), 50)
    with pytest.raises(ValueError, match="several devices"):
        ops.segment_update(assign.to(dev), docs, k=3,
                           init=torch.zeros((50, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.segment_update(assign.to(dev), docs, k=3,
                           init=torch.zeros((3, 50), device=dev).t())


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_on_card(dev, tmp_path, depth):
    """Chunks arrive whole and in order through the pinned ring and the
    side stream, memory and memmapped disk stores alike, while the
    consumer's kernels run on the current stream."""
    from repro_torch.sparse.matrix import SparseDocs
    from repro_torch.sparse.store import ChunkPrefetcher, DocStore

    ids, vals, _, _ = _inputs(1000, 40, 3000, 1, seed=12)
    nnz = (vals != 0).sum(dim=1, dtype=torch.int32)
    mem = DocStore.from_docs(SparseDocs(ids, vals, nnz, 3000),
                             chunk_size=96)
    disk = mem.save(str(tmp_path / "s"))
    for store in (mem, disk):
        feed = ChunkPrefetcher(store, depth=depth, device=dev)
        sums, seen = [], []
        for ci, cdocs in feed:
            assert cdocs.ids.is_cuda and cdocs.ids.shape == (96, 40)
            seen.append(ci)
            sums.append((cdocs.vals.double().sum(), cdocs.ids.sum(),
                         cdocs.nnz.sum()))
        assert seen == list(range(store.n_chunks))
        for ci, (v, i, n) in enumerate(sums):
            h_ids, h_vals, h_nnz = store.host_chunk(ci)
            assert float(v) == float(np.asarray(h_vals, np.float64).sum())
            assert int(i) == int(np.asarray(h_ids).sum())
            assert int(n) == int(np.asarray(h_nnz).sum())
        assert feed.wait_s >= 0.0 and 0 <= feed.late <= store.n_chunks
    with pytest.raises(IndexError):
        list(ChunkPrefetcher(mem, order=[0, 99], device=dev))


def test_streaming_fit_on_card_equals_resident(dev):
    """A four-chunk store fit on the card equals the resident card fit
    bit for bit, through the kernels alone."""
    from repro_torch.core.lloyd import lloyd_fit, streaming_fit
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.sparse.store import DocStore

    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=1200, vocab=2048,
                                            nt_mean=40, n_topics=8, seed=3),
                                 device="cpu")
    rows = draw_seed_rows(1200, 12, seed=3)
    kw = dict(k=12, batch_size=256, seed_rows=rows, df=df, device="cuda",
              keep_trajectory=True)
    want = lloyd_fit(docs, **kw)
    ops.reset_counts()
    got = streaming_fit(DocStore.from_docs(docs, chunk_size=300), **kw)
    torch.cuda.synchronize()
    assert got.n_iter == want.n_iter
    for a, b in zip(got.trajectory, want.trajectory):
        assert torch.equal(a, b)
    for ha, hb in zip(got.history, want.history):
        assert {f: v for f, v in ha.items() if f != "elapsed_s"} == \
            {f: v for f, v in hb.items() if f != "elapsed_s"}
    assert torch.equal(got.state.rho_self, want.state.rho_self)
    assert torch.equal(got.state.index.means_t, want.state.index.means_t)
    assert ops.LAUNCHES["segment_update_init"] > 0
    assert all(v == 0 for v in ops.PLAIN.values()), ops.PLAIN


def test_rho_gather_rejects_rows_past_its_width(dev):
    from repro_torch.kernels.rho_gather import MAX_WIDTH

    p = MAX_WIDTH + 1
    ids = torch.zeros((2, p), dtype=torch.int32, device=dev)
    z = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="exceed"):
        ops.rho_gather(z, ids, ids.float(), torch.zeros((4, 3), device=dev),
                       z)


@pytest.fixture(scope="module")
def serve_models(dev):
    """(docs on the CPU, model A, model B on the card): two fits of one
    small corpus from different seeds, and their rows' width."""
    from repro_torch.cluster import ClusterConfig, fit
    from repro_torch.data import CorpusSpec, make_corpus

    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=1500, vocab=3000,
                                            nt_mean=40, n_topics=12, seed=5),
                                 device="cpu")
    a = fit(docs, ClusterConfig(k=24, max_iter=6, batch_size=512, seed=1,
                                device="cuda"), df=df)
    b = fit(docs, ClusterConfig(k=24, max_iter=2, batch_size=512, seed=9,
                                device="cuda"), df=df)
    return docs, a, b


def _host_rows(docs, lo, hi):
    return (docs.ids[lo:hi].numpy(), docs.vals[lo:hi].numpy(),
            docs.nnz[lo:hi].numpy())


def test_servable_graph_replay_equals_eager_per_bucket(dev, serve_models):
    """Every bucket's graph replay, a batch with dead padding rows, equals
    the eager classify of the same padded batch and ``classify_docs`` on
    its rows bit for bit; one capture a bucket, one replay a batch, and
    no launch through kernels.ops (a replay bypasses it)."""
    from repro_torch.cluster import classify_docs
    from repro_torch.cluster.classify import _classify_fused
    from repro_torch.serve import ServableClusterModel

    docs, model, _ = serve_models
    sv = ServableClusterModel(model, pad_width=docs.pad_width, device=dev)
    assert sv.capture_counts() == dict.fromkeys(sv.sorted_batch_sizes, 1)
    want_a, want_s = classify_docs(model.index, docs.to(dev))
    ops.reset_counts()
    lo = 0
    for bucket in sv.sorted_batch_sizes:
        n = bucket - bucket // 8 if bucket > 8 else bucket
        batch = sv.pre_process([_host_rows(docs, lo, lo + n)])
        assert batch.bucket == bucket
        a, s = sv.post_process(sv.device_compute(batch), n)
        e_a, e_s = _classify_fused(torch.from_numpy(batch.ids).to(dev),
                                   torch.from_numpy(batch.vals).to(dev),
                                   sv.index.means_t)
        assert np.array_equal(a, e_a[:n].cpu().numpy())
        assert np.array_equal(s, e_s[:n].cpu().numpy())
        assert np.array_equal(a, want_a[lo:lo + n].cpu().numpy())
        assert np.array_equal(s, want_s[lo:lo + n].cpu().numpy())
        lo += n
    eager = len(sv.sorted_batch_sizes)
    assert ops.LAUNCHES["sparse_sim"] == eager      # the eager calls only
    assert sv.replay_counts() == dict.fromkeys(sv.sorted_batch_sizes, 1)
    assert sv.capture_counts() == dict.fromkeys(sv.sorted_batch_sizes, 1)


def test_server_swap_under_traffic_on_the_card(dev, serve_models):
    """8 clients while the model is swapped: every answer is model A's
    classify or model B's in full, none fails, each servable captured
    each bucket once (the new one before it took traffic) and never
    again."""
    import threading

    from repro_torch.cluster import classify_docs
    from repro_torch.serve import ClusterServer

    docs, model_a, model_b = serve_models
    want = [classify_docs(m.index, docs.to(dev))[0].cpu().numpy()
            for m in (model_a, model_b)]
    assert (want[0] != want[1]).any()
    srv = ClusterServer(device=dev, max_live_batches=3,
                        batch_timeout_s=0.001)
    try:
        old = srv.load("m", model_a, pad_width=docs.pad_width)
        rng = np.random.default_rng(0)
        plan = [[(int(lo), int(lo + n)) for lo, n in zip(
            rng.integers(0, 1400, 24), rng.integers(1, 64, 24))]
            for _ in range(8)]
        bad, done = [], []

        def client(reqs):
            for lo, hi in reqs:
                try:
                    a, _ = srv.classify("m", _host_rows(docs, lo, hi),
                                        timeout=60)
                except Exception as e:
                    bad.append(repr(e))
                    continue
                if not any((a == w[lo:hi]).all() for w in want):
                    bad.append(f"torn answer for rows {lo}:{hi}")
                done.append(hi - lo)

        threads = [threading.Thread(target=client, args=(p,)) for p in plan]
        for t in threads:
            t.start()
        assert srv.swap("m", model_b) is old
        new = srv.registry.get("m")
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not bad and len(done) == 8 * 24
        a, _ = srv.classify("m", _host_rows(docs, 0, 300), timeout=60)
        assert (a == want[1][:300]).all()
        for sv in (old, new):
            assert sv.capture_counts() == dict.fromkeys(
                sv.sorted_batch_sizes, 1)
        assert srv.stats("m")["n_failures"] == 0
    finally:
        srv.close()


@pytest.fixture(scope="module")
def ivf_model(dev, serve_models):
    """A two-level fit (K 24, K_c 4) of the serving corpus, on the card
    and on the CPU from the same seed rows."""
    from repro_torch.cluster import ClusterConfig, fit
    from repro_torch.core.update import draw_seed_rows

    docs = serve_models[0]
    cfg = ClusterConfig(k=24, coarse_k=4, n_probe=1, max_iter=6,
                        batch_size=512, seed=1)
    rows = lambda n, k, seed: draw_seed_rows(n, k, seed=seed)
    return (fit(docs, cfg.replace(device="cuda"), seed_rows=rows),
            fit(docs, cfg.replace(device="cpu"), seed_rows=rows))


def test_two_level_fit_and_routed_classify_on_card(dev, serve_models,
                                                   ivf_model):
    """The two-level fit on the card equals the CPU fit bit for bit
    (labels, ρ, coarse and fine means), over a store too, and the routed
    classify on the card equals the CPU's at n_probe 1, 2 and 4."""
    from repro_torch.cluster import ClusterConfig, classify_docs_routed, fit
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.sparse.store import DocStore

    docs = serve_models[0]
    gpu, cpu = ivf_model
    assert torch.equal(gpu.labels.cpu(), cpu.labels)
    assert torch.equal(gpu.rho_self.cpu(), cpu.rho_self)
    assert torch.equal(gpu.index.means_t.cpu(), cpu.index.means_t)
    assert torch.equal(gpu.coarse_index.means_t.cpu(),
                       cpu.coarse_index.means_t)
    st = fit(DocStore.from_docs(docs, chunk_size=400),
             ClusterConfig(k=24, coarse_k=4, max_iter=6, batch_size=512,
                           seed=1, device="cuda"),
             seed_rows=lambda n, k, seed: draw_seed_rows(n, k, seed=seed))
    assert torch.equal(st.labels, gpu.labels)
    assert torch.equal(st.index.means_t, gpu.index.means_t)
    for n_probe in (1, 2, 4):
        ops.reset_counts()
        got = classify_docs_routed(gpu, docs.to(dev), n_probe=n_probe,
                                   batch_size=512, with_stats=True)
        assert ops.LAUNCHES["routed_scan"] == (3 if n_probe < 4 else 0)
        assert all(v == 0 for v in ops.PLAIN.values()), ops.PLAIN
        want = classify_docs_routed(cpu, docs, n_probe=n_probe,
                                    batch_size=512, with_stats=True)
        for a, w in zip(got, want):
            assert torch.equal(a.cpu(), w)


def test_servable_routed_graph_replay_equals_classify(dev, serve_models,
                                                      ivf_model):
    """A two-level model behind the servable: one graph per bucket, the
    top-n cell selection and the routed kernel captured in it, each
    replay bit for bit ``classify_docs_routed``."""
    from repro_torch.cluster import classify_docs_routed
    from repro_torch.serve import ServableClusterModel

    docs = serve_models[0]
    model = ivf_model[0]
    sv = ServableClusterModel(model, pad_width=docs.pad_width, device=dev)
    assert sv.capture_counts() == dict.fromkeys(sv.sorted_batch_sizes, 1)
    want_a, want_s = classify_docs_routed(model, docs.to(dev))
    ops.reset_counts()
    lo = 0
    for bucket in sv.sorted_batch_sizes:
        n = bucket - bucket // 8 if bucket > 8 else bucket
        batch = sv.pre_process([_host_rows(docs, lo, lo + n)])
        a, s = sv.post_process(sv.device_compute(batch), n)
        assert np.array_equal(a, want_a[lo:lo + n].cpu().numpy())
        assert np.array_equal(s, want_s[lo:lo + n].cpu().numpy())
        lo += n
    assert ops.LAUNCHES["routed_scan"] == 0        # replays bypass ops
    assert sv.replay_counts() == dict.fromkeys(sv.sorted_batch_sizes, 1)


def test_refit_on_card_equals_cpu_and_store(dev, serve_models):
    """``ClusterEngine.refit`` on the card: resident and over a 4-chunk
    store bit for bit (assign, ρ, means), and equal to the CPU refit; the
    update ran segment_update (both launches) and rho_gather, no plain
    version."""
    from repro_torch.serve import ClusterEngine
    from repro_torch.sparse.store import DocStore

    docs, model, _ = serve_models
    cpu = ClusterEngine.from_model(model, device="cpu", batch_size=256)
    c_a, c_r = cpu.refit(docs, n_iter=2)
    ops.reset_counts()
    res = ClusterEngine.from_model(model, device=dev, batch_size=256)
    r_a, r_r = res.refit(docs, n_iter=2)
    st = ClusterEngine.from_model(model, device=dev, batch_size=256)
    s_a, s_r = st.refit(DocStore.from_docs(docs, chunk_size=400), n_iter=2)
    torch.cuda.synchronize()
    assert torch.equal(r_a, s_a) and torch.equal(r_r, s_r)
    assert torch.equal(res.index.means_t, st.index.means_t)
    assert torch.equal(r_a.cpu(), c_a) and torch.equal(r_r.cpu(), c_r)
    assert torch.equal(res.index.means_t.cpu(), cpu.index.means_t)
    for name in ("sparse_sim", "segment_update", "segment_update_init",
                 "rho_gather"):
        assert ops.LAUNCHES[name] > 0, name
    assert all(v == 0 for v in ops.PLAIN.values()), ops.PLAIN


# ---------------------------------------------------------------------------
# The autotuner's settings (repro_torch.tune) on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting", range(8))
@pytest.mark.parametrize("shape", SHAPES)
def test_tuned_gathers_equal_plain(dev, setting, shape):
    """Every setting a tuned fit can launch, through the wrappers: sims
    with counts and without, esicp with counts, bit for bit."""
    from repro_torch.tune import TunedConfig

    ids, vals, means, _ = _inputs(*shape, seed=21)
    g = [x.to(dev) for x in (ids, vals, means)]
    cfg = TunedConfig(sims_setting=setting % 4, esicp_setting=setting % 4,
                      slab_fastest=setting >= 4)
    t_th, v_th = int(0.6 * shape[2]), 0.3
    ops.reset_counts()
    for counts in (True, False):
        got = ops.sparse_sim(*g, with_counts=counts, tuned=cfg)
        want = ref.sparse_sim(*g, with_counts=counts)
        assert torch.equal(got[0], want[0])
        assert not counts or torch.equal(got[1], want[1])
    got = ops.esicp_gather(*g, t_th, v_th, with_counts=True, tuned=cfg)
    want = ref.esicp_gather(*g, t_th, v_th, with_counts=True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert ops.LAUNCHES["sparse_sim"] == 2
    assert ops.LAUNCHES["esicp_gather"] == 1


def test_port_tile_table_equals_the_library(dev):
    """tune/config.py's copy of gather.cu's tile table and of which
    (gather, counts, setting) it instantiates."""
    from repro_torch.kernels import esicp_gather as kern
    from repro_torch.tune.config import MODES, TILES, instantiated

    lib = kern.library()
    for gather, tiles in TILES.items():
        mode = MODES[gather]
        for s in range(8):
            assert lib.gather_tile_docs(mode, s) == tiles[s % 4][0]
            for counts in (0, 1):
                n = lib.gather_blocks_per_sm(mode, s, counts)
                assert (n >= 1) == instantiated(gather, counts, s), (
                    gather, s, counts, n)
    assert lib.gather_tile_docs(kern.SIMS, 8) == -1


def test_scratch_and_row_ceiling_per_setting(dev):
    """A 7-document tile needs more plan scratch than a 14-document one,
    and each setting has its own row ceiling, which the wrapper checks."""
    from repro_torch.kernels import esicp_gather as kern
    from repro_torch.tune import TunedConfig

    lib = kern.library()
    b, p, d = 4096, 431, 495_126
    s0 = lib.gather_scratch_bytes(b, p, d, kern.ESICP, 0)
    s1 = lib.gather_scratch_bytes(b, p, d, kern.ESICP, 1)
    assert s1 > s0 > 0
    assert kern.scratch(lib, torch.zeros((b, p), dtype=torch.int32,
                                         device=dev), d, kern.ESICP,
                        1).numel() == s1
    for mode in (kern.SIMS, kern.SQUARE, kern.ESICP, kern.TA):
        for s in range(8):
            bt = lib.gather_tile_docs(mode, s)
            assert lib.gather_max_rows(mode, s) == (65535 * bt if bt > 0
                                                    else -1)
    rows = 65535 * 7 + 1            # past setting 1's ceiling, not 0's
    ids = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    vals = torch.ones((rows, 1), device=dev)
    means = torch.rand((4, 1), device=dev)
    with pytest.raises(ValueError, match="setting 1"):
        ops.esicp_gather(ids, vals, means, 2, 0.5, with_counts=True,
                         tuned=TunedConfig(esicp_setting=1))
    got = ops.esicp_gather(ids, vals, means, 2, 0.5, with_counts=True)
    assert torch.equal(got[2], ref.esicp_gather(ids, vals, means, 2, 0.5)[2])


@pytest.fixture
def clean_tuner():
    from repro_torch.tune import TUNED_CACHE

    TUNED_CACHE.clear()
    yield TUNED_CACHE
    TUNED_CACHE.clear()


def _same_fit(got, want):
    assert got.n_iter == want.n_iter
    for ha, hb in zip(got.history, want.history):
        assert {f: v for f, v in ha.items() if f != "elapsed_s"} == \
            {f: v for f, v in hb.items() if f != "elapsed_s"}
    assert torch.equal(got.assign, want.assign)
    assert torch.equal(got.state.rho_self, want.state.rho_self)
    assert torch.equal(got.state.index.means_t, want.state.index.means_t)


@pytest.mark.parametrize("algo", ["esicp", "bounds", "cs-icp", "minibatch"])
def test_tuned_fit_equals_untuned_on_card(dev, clean_tuner, algo):
    """A fit at a decidedly non-default setting, cached for its corpus,
    equals the untuned fit bit for bit (resident, or the streaming
    minibatch fit); the result carries the config."""
    from repro_torch.core.lloyd import lloyd_fit, streaming_fit
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.sparse.store import DocStore
    from repro_torch.tune import TunedConfig, corpus_signature

    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=1500, vocab=3000,
                                            nt_mean=40, n_topics=8, seed=5),
                                 device="cuda")
    k = 300
    kw = dict(k=k, batch_size=512, seed_rows=draw_seed_rows(1500, k, seed=5),
              df=df, device="cuda", max_iter=4)
    if algo == "minibatch":
        store = DocStore.from_docs(docs.to("cpu"), chunk_size=500)
        fit = lambda **t: streaming_fit(store, algo_mode="minibatch", **kw,
                                        **t)
        sig_docs = store.chunk(0).slice_rows(0, 500).to(dev)
    else:
        fit = lambda **t: lloyd_fit(docs, algo=algo, **kw, **t)
        sig_docs = docs
    want = fit()
    cfg = clean_tuner.put(
        corpus_signature(sig_docs.ids, sig_docs.vals, dim=docs.dim, k=k),
        TunedConfig(sims_setting=2, esicp_setting=1, slab_fastest=True,
                    source="manual"))
    ops.reset_counts()
    got = fit(tune="cached")
    assert got.tuned == cfg
    _same_fit(got, want)
    assert all(v == 0 for v in ops.PLAIN.values()), ops.PLAIN


def test_search_on_card_caches_and_reuses(dev, clean_tuner):
    """ensure_tuned's modes on CUDA operands, and a searched fit equal to
    the untuned one; a second fit hits the cache."""
    from repro_torch.core.lloyd import lloyd_fit
    from repro_torch.data import CorpusSpec, make_corpus
    from repro_torch.tune import SearchBudget, ensure_tuned

    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=1200, vocab=2048,
                                            nt_mean=40, n_topics=8, seed=6),
                                 device="cuda")
    budget = SearchBudget(max_timed=3, repeat=1, probe_rows=512)
    assert ensure_tuned(docs, k=40, mode="cached") is None
    cfg = ensure_tuned(docs, k=40, mode="search", budget=budget)
    assert cfg is not None and cfg.signature.startswith(
        torch.cuda.get_device_name(dev) + "/")
    stats = clean_tuner.last_search
    assert clean_tuner.searches == 1 and stats.n_timed <= 3
    assert stats.probe_bytes == docs.dim * 40 * 4 and stats.peak_bytes > 0
    assert ensure_tuned(docs, k=40, mode="cached") == cfg
    clean_tuner.clear()
    kw = dict(k=40, batch_size=400, df=df, device="cuda", max_iter=3)
    want = lloyd_fit(docs, **kw)
    got = lloyd_fit(docs, tune="search", tune_budget=budget, **kw)
    assert clean_tuner.searches == 1 and got.tuned is not None
    _same_fit(got, want)
    again = lloyd_fit(docs, tune="search", tune_budget=budget, **kw)
    assert clean_tuner.searches == 1 and again.tuned == got.tuned


# ---------------------------------------------------------------------------
# The mesh runtime on the card.
# ---------------------------------------------------------------------------

MESH_ALGOS = ("esicp", "mivi", "icp", "bounds", "sketch", "bounds-esicp")
MESH_K, MESH_ITER = 18, 6


def _mesh_inputs():
    from repro_torch.core.update import draw_seed_rows
    from repro_torch.data import CorpusSpec, make_corpus

    docs, df, _, _ = make_corpus(CorpusSpec(n_docs=1200, vocab=2048,
                                            nt_mean=40, n_topics=8, seed=5),
                                 device="cpu")
    return docs, df, draw_seed_rows(1200, MESH_K, seed=5)


def _mesh_lloyd(docs, df, rows, algo):
    from repro_torch.core.lloyd import lloyd_fit

    return lloyd_fit(docs, k=MESH_K, algo=algo, batch_size=256,
                     max_iter=MESH_ITER, seed_rows=rows, df=df,
                     device="cuda",
                     params="auto" if algo == "esicp" else None)


def _mesh_same_as_lloyd(got: dict, want, *, exact: bool = True):
    assert np.array_equal(got["assign"], want.assign.cpu().numpy())
    if exact:
        for name, ref_t in (("rho", want.state.rho_self),
                            ("means", want.state.index.means_t),
                            ("ub", want.state.ub)):
            assert np.array_equal(got[name], ref_t.cpu().numpy()), name
        ints = ("iteration", "n_changed", "n_candidates", "t_th")
        assert ([{f: h[f] for f in ints} for h in got["history"]]
                == [{f: h[f] for f in ints} for h in want.history])
    else:
        np.testing.assert_allclose(got["means"],
                                   want.state.index.means_t.cpu().numpy(),
                                   rtol=0, atol=1e-6)


def _mesh_card_rank(arrays, rows, shape, algo, span):
    """A spawned rank on the card (gloo on CUDA tensors): the mesh fit,
    gathered, as numpy, with the plain-version counts."""
    from repro_torch.convert import docs_from_numpy
    from repro_torch.distributed import kmeans
    from repro_torch.launch.mesh import make_test_mesh

    kmeans.LAMBDA_SPAN = span
    mesh = make_test_mesh(shape, device="cuda")
    docs = docs_from_numpy(*arrays, device="cpu")
    ops.reset_counts()
    state, hist, _, _ = kmeans.mesh_fit(docs, MESH_K, mesh, algo=algo,
                                        max_iter=MESH_ITER, obj_chunk=256,
                                        seed_rows=rows)
    means, _, assign, rho, _, ub = kmeans.gather_state(mesh, state)
    return {"assign": assign.cpu().numpy(), "rho": rho.cpu().numpy(),
            "means": means.cpu().numpy(), "ub": ub.cpu().numpy(),
            "history": hist, "plain": dict(ops.PLAIN),
            "launches": dict(ops.LAUNCHES)}


@pytest.mark.parametrize("algo", MESH_ALGOS)
def test_mesh_world_of_one_on_card_equals_lloyd(dev, algo, monkeypatch):
    """A world of one on the card equals lloyd_fit on the card bit for
    bit, λ accumulated in spans of 300 rows (the init launch runs)."""
    from repro_torch.distributed import kmeans
    from repro_torch.launch.mesh import make_test_mesh

    docs, df, rows = _mesh_inputs()
    want = _mesh_lloyd(docs, df, rows, algo)
    monkeypatch.setattr(kmeans, "LAMBDA_SPAN", 300)
    ops.reset_counts()
    state, hist, _, _ = kmeans.mesh_fit(
        docs, MESH_K, make_test_mesh((1, 1), device="cuda"), algo=algo,
        max_iter=MESH_ITER, obj_chunk=256, seed_rows=rows, df=df)
    torch.cuda.synchronize()
    assert all(v == 0 for v in ops.PLAIN.values()), ops.PLAIN
    assert ops.LAUNCHES["segment_update_init"] > 0
    _mesh_same_as_lloyd({"assign": state.assign[:1200].cpu().numpy(),
                         "rho": state.rho_self[:1200].cpu().numpy(),
                         "means": state.means_t.cpu().numpy(),
                         "ub": state.ub[:1200].cpu().numpy(),
                         "history": hist}, want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_mesh_two_ranks_gloo_on_one_card(dev, shape, tmp_path):
    """Two spawned ranks sharing the card through gloo: (1, 2) equals
    lloyd_fit bit for bit, (2, 1) its assignments (λ summed over the two
    object shards: means within 1e-6)."""
    from repro_torch.launch.mesh import run_local_world

    docs, df, rows = _mesh_inputs()
    want = _mesh_lloyd(docs, df, rows, "esicp")
    arrays = (docs.ids.numpy(), docs.vals.numpy(), docs.nnz.numpy(),
              docs.dim, df.cpu().numpy())
    outs = run_local_world(_mesh_card_rank, 2, backend="gloo",
                           timeout=300, workdir=str(tmp_path),
                           args=(arrays, rows.numpy(), shape, "esicp", 300))
    for got in outs:
        assert all(v == 0 for v in got["plain"].values()), got["plain"]
        assert got["launches"]["esicp_gather"] > 0
        _mesh_same_as_lloyd(got, want, exact=shape == (1, 2))


_T = SLSTM_TILE
SLSTM_SHAPES = [(2, 4096, 768, 1.0, False), (4, 1, 768, 1.0, True),
                (3, 200, 100, 1.0, True), (2, 4096, 768, 10.0, False),
                (5, 37, 33, 3.0, True),
                # the ring's edges: a tile less one step, one tile, one
                # step more, three tiles and 5 steps, 16,384 steps
                (2, _T - 1, 768, 1.0, False), (2, _T, 768, 1.0, True),
                (2, _T + 1, 768, 1.0, True), (2, 3 * _T + 5, 768, 3.0, True),
                (2, 16384, 768, 1.0, False),
                # D not a multiple of the channel group; B·D below one
                # group (and D not a multiple of 4: 4-byte copies)
                (3, 3 * _T + 5, 100, 1.0, True), (1, _T + 1, 7, 1.0, True),
                # the walk's last S and the tiles' first
                (4, SLSTM_WALK - 1, 768, 1.0, True),
                (4, SLSTM_WALK, 768, 1.0, True)]


def _slstm_inputs(dev, b, s, d, scale, cached, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    gates = torch.randn((b, s, 4 * d), generator=gen, device=dev) * scale
    if cached:
        state = (torch.randn((b, d), generator=gen, device=dev),
                 torch.rand((b, d), generator=gen, device=dev) * 4 + 0.5,
                 torch.randn((b, d), generator=gen, device=dev) * 3)
    else:
        zero = torch.zeros((b, d), device=dev)
        state = (zero, zero, torch.full((b, d), -1e30, device=dev))
    return gates, state


@pytest.mark.parametrize("b,s,d,scale,cached", SLSTM_SHAPES)
def test_slstm_scan_equals_plain(dev, b, s, d, scale, cached):
    """One launch, hs and the final (c, n, m) bit for bit against the
    plain loop on the card; the state carried over S/2 + S/2 launches
    equals one launch bit for bit."""
    gates, state = _slstm_inputs(dev, b, s, d, scale, cached, seed=b * s + d)
    ops.reset_counts()
    got = ops.slstm_scan(gates, *state)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["slstm_scan"] == 1 and ops.PLAIN["slstm_scan"] == 0
    want = ref.slstm_scan(gates, *state)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    if s > 1:
        half = s // 2
        first = ops.slstm_scan(gates[:, :half].contiguous(), *state)
        second = ops.slstm_scan(gates[:, half:].contiguous(), *first[1:])
        assert torch.equal(torch.cat([first[0], second[0]], dim=1), got[0])
        for g, w in zip(second[1:], got[1:]):
            assert torch.equal(g, w)


def test_slstm_scan_gates_off_16_byte_alignment(dev):
    """Gates 4 bytes past a 16-byte boundary (a contiguous view at an
    offset) take the 4-byte copies: bit for bit as from aligned gates."""
    b, s, d = 2, 3 * SLSTM_TILE + 5, 96
    gates, state = _slstm_inputs(dev, b, s, d, 1.0, True, seed=11)
    buf = torch.empty((gates.numel() + 1,), device=dev)
    off = buf[1:].view(gates.shape)
    off.copy_(gates)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    ops.reset_counts()
    got = ops.slstm_scan(off, *state)
    assert ops.LAUNCHES["slstm_scan"] == 1
    for g, w in zip(got, ops.slstm_scan(gates, *state)):
        assert torch.equal(g, w)
    for g, w in zip(got, ref.slstm_scan(gates, *state)):
        assert torch.equal(g, w)


def test_slstm_scan_operands_the_kernel_cannot_take_raise(dev):
    gates = torch.zeros((2, 6, 4 * 8), device=dev)
    z = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError, match="several devices"):
        ops.slstm_scan(gates, z.cpu(), z, z)
    with pytest.raises(ValueError, match="contiguous"):
        ops.slstm_scan(gates.transpose(0, 1).contiguous().transpose(0, 1),
                       z, z, z)


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_ssm_smoke_archs_on_card_equal_cpu(dev, arch):
    """Float32 on both: prefill logits within 1e-4, decode logits step by
    step within 1e-4, the states after the prompt within 1e-5 and greedy
    tokens identical; the card's prefill launched flash_attention once per
    shared_attn invocation and slstm_scan once per sLSTM layer, its decode
    slstm_scan once per sLSTM layer a step, and no plain version ran."""
    from repro_torch.models.transformer import (decode_forward, init_cache,
                                                layer_specs)
    from repro_torch.serve.lm import ServeLoop, make_prefill_fn

    cfg, params = _smoke_pair(arch, dev)
    assert all(lp is params["cuda"]["shared"] for lp, sp in
               zip(params["cuda"]["layers"], layer_specs(cfg))
               if sp.kind == "shared_attn")
    kinds = [sp.kind for sp in layer_specs(cfg)]
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=gen)
    f32 = torch.float32
    lg = {}
    for where in ("cuda", "cpu"):
        ops.reset_counts()
        lg[where] = make_prefill_fn(cfg, compute_dtype=f32)(params[where],
                                                             toks.to(where))
        if where == "cuda":
            torch.cuda.synchronize()
            assert ops.LAUNCHES["flash_attention"] == kinds.count("shared_attn")
            assert ops.LAUNCHES["slstm_scan"] == kinds.count("slstm")
            assert not any(ops.PLAIN.values())
    torch.testing.assert_close(lg["cuda"].cpu(), lg["cpu"], rtol=1e-4,
                               atol=1e-4)
    caches = {w: init_cache(cfg, 2, 16, device=w, compute_dtype=f32)
              for w in ("cuda", "cpu")}
    ops.reset_counts()
    for pos in range(12):
        step = {w: decode_forward(params[w], caches[w],
                                  toks[:, pos:pos + 1].to(w), pos, cfg,
                                  compute_dtype=f32)[0]
                for w in ("cuda", "cpu")}
        torch.testing.assert_close(step["cuda"].cpu(), step["cpu"],
                                   rtol=1e-4, atol=1e-4)
    assert ops.LAUNCHES["slstm_scan"] == 12 * kinds.count("slstm")
    for got, want in zip(caches["cuda"], caches["cpu"]):
        for name in got:
            torch.testing.assert_close(got[name].cpu(), want[name],
                                       rtol=1e-5, atol=1e-5)
    out = {w: ServeLoop(cfg, params[w], max_len=32, compute_dtype=f32).generate(
        toks[:, :8].to(w), n_new=16) for w in ("cuda", "cpu")}
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


# ---------------------------------------------------------------------------
# The backward kernels (training)
# ---------------------------------------------------------------------------

def _plain_attention_grads(q, k, v, do, window, sk_real, dtype):
    xs = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention(*xs, window, sk_real)
    return torch.autograd.grad(out, xs, do.to(dtype))


@pytest.mark.parametrize("bh,sq,sk,hd,window,sk_real", FLASH_SHAPES)
def test_flash_attention_bwd_close_to_float64(dev, bh, sq, sk, hd, window,
                                              sk_real):
    """The backward through ops.flash_attention's autograd Function: each
    of dq, dk, dv within 2× the plain float32 gradient's own max abs error
    against float64 autograd through the plain version, and within 1e-4 of
    its largest magnitude; two runs bit for bit; a row with no live key
    and a key at or past sk_real get exactly 0."""
    _check_bwd_close_to_float64(dev, bh, sq, sk, hd, window, sk_real)


# The backward's tiles (csrc/flash_attention_bwd.cu: kBQ, kBK, kKvRows):
# storage blocks of QT queries × KT keys, the key launch's query tiles of
# KV rows.
QT, KT, KV = 64, 32, 32
FLASH_BWD_EDGES = [
    # Sq, Sk not multiples of either tile, Sq != Sk
    (2, QT + KT + 1, 2 * QT + 3, 64, -1, None),
    (2, 2 * QT + 5, QT + KT - 1, 128, -1, None),
    (3, KV - 1, KT + 1, 32, -1, None),
    # window 1 (every row one key) and windows just above each tile
    (2, 2 * QT + 7, 2 * QT + 7, 256, 1, None),
    (2, 3 * QT + 1, 3 * QT + 1, 64, KT + 1, None),
    (2, 3 * QT + 1, 3 * QT + 1, 256, QT + 1, None),
    (2, 4 * QT, 4 * QT, 128, KV + 1, None),
    # sk_real < Sk: whole key tiles and part of one past it
    (2, 3 * QT, 3 * QT, 64, -1, KT + 5),
    (2, 2 * QT + 9, 3 * QT, 256, 2 * KT + 3, QT + 1),
    # every instantiated hd on a ragged causal shape
    *[(2, 2 * QT + 11, 2 * QT + 11, hd, -1, None) for hd in FA.HEAD_DIMS],
]


@pytest.mark.parametrize("bh,sq,sk,hd,window,sk_real", FLASH_BWD_EDGES)
def test_flash_attention_bwd_edges_close_to_float64(dev, bh, sq, sk, hd,
                                                    window, sk_real):
    """The backward at the edges of its tiles, held as
    test_flash_attention_bwd_close_to_float64 holds it."""
    _check_bwd_close_to_float64(dev, bh, sq, sk, hd, window, sk_real)


@pytest.mark.parametrize("hd,window", [(64, -1), (256, -1), (32, 1),
                                       (256, 1)])
def test_flash_attention_bwd_one_live_key_gives_zero_dq(dev, hd, window):
    """A row with one live key has P = 1 and dS = 0 exactly, so its dq is
    exactly 0: row 0 of a causal case, every row at window 1 (where every
    dk is 0 too)."""
    gen = torch.Generator(device=dev).manual_seed(hd + window)
    q, k, v, do = (torch.randn((3, 2 * QT + 5, hd), generator=gen,
                               device=dev) for _ in range(4))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    dq, dk, _ = torch.autograd.grad(ops.flash_attention(*xs, window=window),
                                    xs, do)
    assert bool((dq[:, 0] == 0).all())
    if window == 1:
        assert bool((dq == 0).all()) and bool((dk == 0).all())
    else:
        assert bool((dq[:, 1:].abs().amax(dim=-1) > 0).all())


# Shapes whose heads' scratch would pass 1 GiB together, so the backward
# runs over slices of heads: 4 heads at S 8192 in slices of 3 and 1, and
# heads at S 16,384 that need more than 1 GiB each, a slice apiece.
FLASH_BWD_SLICED = [(4, 8192, 64), (2, 16384, 32)]


@pytest.mark.parametrize("bh,s,hd", FLASH_BWD_SLICED)
def test_flash_attention_bwd_runs_over_slices_of_heads(dev, bh, s, hd):
    """Full causal at long S: the scratch holds at most 1 GiB or one
    head's, whatever BH; the gradients meet the float64 bars and equal,
    bit for bit, each head's run alone."""
    floats = FA.bwd_library().flash_attention_bwd_scratch_floats
    one = floats(1, s, s, -1)
    assert floats(bh, s, s, -1) < bh * one
    assert floats(bh, s, s, -1) * 4 <= max(2**30, one * 4)
    (q, k, v, do), got = _check_bwd_close_to_float64(dev, bh, s, s, hd, -1,
                                                     None)
    for b in range(bh):
        xs = [t[b:b + 1].clone().requires_grad_() for t in (q, k, v)]
        alone = torch.autograd.grad(ops.flash_attention(*xs), xs,
                                    do[b:b + 1])
        assert all(torch.equal(a, g[b:b + 1]) for a, g in zip(alone, got))


def _check_bwd_close_to_float64(dev, bh, sq, sk, hd, window, sk_real):
    gen = torch.Generator(device=dev).manual_seed(bh * sq + hd + 7)
    q, k, v = (torch.randn((bh, n, hd), generator=gen, device=dev)
               for n in (sq, sk, sk))
    do = torch.randn((bh, sq, hd), generator=gen, device=dev)
    runs = []
    for _ in range(2):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_counts()
        out = ops.flash_attention(*xs, window=window, sk_real=sk_real)
        assert out.grad_fn is not None
        runs.append(torch.autograd.grad(out, xs, do))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == 1
        assert ops.LAUNCHES["flash_attention_bwd"] == 1
        assert not any(ops.PLAIN.values())
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    want64 = _plain_attention_grads(q, k, v, do, window, sk_real,
                                    torch.float64)
    want32 = _plain_attention_grads(q, k, v, do, window, sk_real,
                                    torch.float32)
    for got, w64, w32 in zip(runs[0], want64, want32):
        err = float((got.double() - w64).abs().max())
        plain_err = float((w32.double() - w64).abs().max())
        assert err <= 2 * plain_err and err <= 1e-4 * float(w64.abs().max())
    live_keys = sk if sk_real is None else sk_real
    assert bool((runs[0][1][:, live_keys:] == 0).all())
    assert bool((runs[0][2][:, live_keys:] == 0).all())
    if window > 0 and sq >= live_keys + window:
        assert bool((runs[0][0][:, live_keys + window - 1:] == 0).all())
    return (q, k, v, do), runs[0]


@pytest.mark.parametrize("hd", [12, 80, 200])
def test_flash_attention_bwd_pads_any_head_dim(dev, hd):
    """A head dim without an instantiation: the gradients come back at hd,
    within 1e-5 of float32 autograd through the plain version."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    q, k, v, do = (torch.randn((3, 150, hd), generator=gen, device=dev)
                   for _ in range(4))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*xs, window=48), xs, do)
    want = _plain_attention_grads(q, k, v, do, 48, None, torch.float32)
    for g, w in zip(got, want):
        assert g.shape == (3, 150, hd)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_kernel_outputs_keep_the_gradient(dev):
    """A CUDA operand that needs a gradient gets an output with a grad_fn
    from both kernels; without grad mode the serving launch runs."""
    q = torch.randn((2, 40, 32), device=dev, requires_grad=True)
    assert ops.flash_attention(q, q, q).grad_fn is not None
    gates = torch.randn((2, 9, 32), device=dev, requires_grad=True)
    z = torch.zeros((2, 8), device=dev)
    outs = ops.slstm_scan(gates, z, z, torch.full_like(z, -1e30))
    assert all(t.grad_fn is not None for t in outs)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
        assert ops.slstm_scan(gates, z, z, z)[0].grad_fn is None


_BT, _BW = BWD_TILE, BWD_WALK_BELOW
SLSTM_BWD_SHAPES = [(2, 300, 100, False), (4, 1, 768, True),
                    (3, 81, 36, True), (1, 5, 7, True), (2, 97, 64, False),
                    # the walk's last S, the tiles' first, one step more
                    (4, _BW - 1, 768, True), (4, _BW, 768, True),
                    (4, _BW + 1, 768, True),
                    # a tile and one step, three tiles and one step
                    (2, _BT + 1, 768, False), (2, 3 * _BT + 1, 768, True),
                    # D not a multiple of the block's channels (D % 4 == 0:
                    # 16-byte copies of a partial group; else 4-byte ones)
                    (3, 2 * _BT + 5, BWD_CHANNELS + 4, True),
                    (2, 2 * _BT + 3, 50, True), (1, _BT + 7, 7, True),
                    # a cached state with ties at step 0: f + m == i and
                    # n' == 1, through the walk and through the tiles
                    (2, _BW - 1, 96, "ties"), (2, 3 * _BT + 1, 96, "ties")]


def _tie_step_0(gates, state):
    """Even channels tie at step 0 from the cached state: m0 = 0 and f =
    i make f + m == i (m' = i, ie = 1), and n0 = 0 makes n' = ie = 1."""
    d = gates.shape[-1] // 4
    c0, n0, m0 = (t.clone() for t in state)
    gates = gates.clone()
    m0.zero_()
    n0[:, ::2] = 0.0
    gates[:, 0, 2 * d:3 * d][:, ::2] = gates[:, 0, d:2 * d][:, ::2]
    return gates, (c0, n0, m0)


@pytest.mark.parametrize("b,s,d,cached", SLSTM_BWD_SHAPES)
def test_slstm_scan_bwd_equals_plain(dev, b, s, d, cached):
    """The backward through ops.slstm_scan's autograd Function bit for bit
    against the plain reverse loop on the card, every input's gradient for
    adjoints of hs and of the final (c, n, m); a second run gives the same
    bits; S/2 + S/2 with the adjoints carried equals one launch."""
    from repro_torch.kernels import slstm_scan as kern

    gates, state = _slstm_inputs(dev, b, s, d, 2.0, bool(cached),
                                 seed=b + s + d)
    if cached == "ties":
        gates, state = _tie_step_0(gates, state)
    gen = torch.Generator(device=dev).manual_seed(s)
    adj = (torch.randn((b, s, d), generator=gen, device=dev),
           *(torch.randn((b, d), generator=gen, device=dev)
             for _ in range(3)))
    xs = [t.clone().requires_grad_() for t in (gates, *state)]
    ops.reset_counts()
    got = torch.autograd.grad(ops.slstm_scan(*xs), xs, adj)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["slstm_scan"] == 1
    assert ops.LAUNCHES["slstm_scan_bwd"] == 1
    assert not any(ops.PLAIN.values())
    want = ref.slstm_scan_bwd(gates, *state, *adj)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    again = torch.autograd.grad(ops.slstm_scan(*xs), xs, adj)
    assert all(torch.equal(g, w) for g, w in zip(again, got))
    if s > 1:
        h = s // 2

        def kernel_bwd(gp, st, a):
            out = [torch.empty_like(gp), *(torch.empty_like(x) for x in st)]
            kern.launch_bwd(gp, *st, *(x.contiguous() for x in a),
                            torch.empty((3, b, gp.shape[1], d), device=dev),
                            *out)
            return out

        g1, g2 = gates[:, :h].contiguous(), gates[:, h:].contiguous()
        mid = ops.slstm_scan(g1, *state)[1:]
        second = kernel_bwd(g2, mid, (adj[0][:, h:], *adj[1:]))
        first = kernel_bwd(g1, state, (adj[0][:, :h], *second[1:]))
        assert torch.equal(torch.cat([first[0], second[0]], dim=1), got[0])
        assert all(torch.equal(a, w) for a, w in zip(first[1:], got[1:]))


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-125m", "zamba2-2.7b",
                                  "granite-moe-3b-a800m"])
def test_smoke_train_grads_on_card_equal_cpu(dev, arch):
    """The loss and gradients of a smoke config in float32, the card (the
    kernels, two forward launches a layer with remat and one backward)
    against the CPU (autograd through the plain versions): the loss within
    1e-4, every gradient leaf within 1e-3 of its largest magnitude."""
    from repro_torch.models.transformer import ATTN_KINDS, layer_specs
    from repro_torch.train import TrainConfig, make_grad_fn
    from repro_torch.models.transformer import tree_leaves

    cfg, params = _smoke_pair(arch, dev)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(5))
    grad_fn = make_grad_fn(cfg, TrainConfig(loss_chunk=16,
                                            compute_dtype=torch.float32))
    got = {}
    for where in ("cuda", "cpu"):
        ops.reset_counts()
        t = toks.to(where)
        got[where] = grad_fn(params[where], t, torch.roll(t, -1, dims=1))
        if where == "cuda":
            torch.cuda.synchronize()
            kinds = [spec.kind for spec in layer_specs(cfg)]
            n_attn = sum(k in ATTN_KINDS for k in kinds)
            assert ops.LAUNCHES["flash_attention"] == 2 * n_attn
            assert ops.LAUNCHES["flash_attention_bwd"] == n_attn
            assert ops.LAUNCHES["slstm_scan"] == 2 * kinds.count("slstm")
            assert ops.LAUNCHES["slstm_scan_bwd"] == kinds.count("slstm")
            assert not any(ops.PLAIN.values())
    assert abs(float(got["cuda"][0]) - float(got["cpu"][0])) <= 1e-4
    for g, w in zip(tree_leaves(got["cuda"][1]), tree_leaves(got["cpu"][1])):
        top = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * top or top == 0.0
