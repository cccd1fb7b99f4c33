"""CUDA kernel: fused ES-filter gathering phase (paper Alg. 3 / G_0, G_1).

Replaces ``repro/kernels/esicp_gather.py:esicp_gather_pallas``
(``_gather_kernel``).  One pass over the object tuples produces, per
(object b, centroid k):

    rho12[b,k] = Σ_{s<t_th} u·v + Σ_{s≥t_th, v≥v_th} u·v     (exact part)
    y[b,k]     = Σ_{s≥t_th, v<v_th} u                         (Region-3 mass)
    sims[b,k]  = x_b·μ_k                                      (exact sims)
    counts[b,k]= Σ live·[v > 0 ∧ exact]                       (Mult, optional)

Source: ``csrc/gather.cu`` (template ``gather_tiled<kEsicp>``); plain
version: :func:`repro_torch.kernels.ref.esicp_gather`.

What bounds it on the card.  The TPU kernel densified each (B_blk, D_blk)
slab and fed the MXU: at the NYT widths (D 495,126, K 10,000) that is a
B×D×K product.  Here the mean-inverted index is gathered directly: the
work is nnz·K multiply-adds, and the traffic is the means rows the tuples
name.  A walk tuple by tuple re-reads a row segment for every tuple (36 GB
for a 4096-document batch, 7.3 GB of it distinct).  So the kernel works
on tiles of 14 documents × 256 columns.  A plan per launch lists each
tile's distinct ids.  A producer warp stages their segments once per tile
in shared memory (bulk copies, a 3-deep ring on mbarriers; 27 GB in all),
and the tile's documents read them there.  Column slabs go slowest, so
the blocks in flight share a few slabs in L2.  Over the head (id < t_th)
rho12 and sims take the same adds, so one accumulator serves both until
the tile's ids cross t_th; only the tail pays for the region selects.
``scripts/gather_probe.py`` measured it on an H100 (80GB HBM3, 700 W):
6.5 ms for a 4096-document NYT batch against 24.2 for the tuple walk,
and 3.8 ms when every row is L2-resident.  That leaves the shared-memory
reads and issue (counts included) as one bound and L2 misses as the
other.  No tensor cores, no TF32: fp32 stays fp32.

The ``ta`` variant (``gather_tiled<kTa>``, :func:`launch_ta`) serves
TA-ICP (paper App. F-A): each document brings its own value threshold
v_ta[b] = ρ_self / ||x||_1 in place of the shared v_th, held in a register
of the warp that owns the document.  ``repro`` has no Pallas kernel for it
(its per-object threshold does not fit the densified slab) and runs the
TAAT scan, ``reference_scan(mode="ta")``.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import esicp_gather as plain  # noqa: F401

_SIG = {
    "esicp_gather_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_float, _build.c_float,
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr]),
    "esicp_gather_ta_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_float, _build.ptr,
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr]),
    "sparse_sim_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_int, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr]),
    "gather_setting_launch": (_build.c_int, [
        _build.c_int, _build.c_int, _build.ptr, _build.ptr, _build.ptr,
        _build.c_int, _build.c_int, _build.c_int, _build.c_int,
        _build.c_float, _build.c_float, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr, _build.ptr, _build.ptr]),
    "gather_scratch_bytes": (_build.c_longlong, [
        _build.c_int, _build.c_int, _build.c_int, _build.c_int,
        _build.c_int]),
    "gather_tile_docs": (_build.c_int, [_build.c_int, _build.c_int]),
    "gather_blocks_per_sm": (_build.c_int, [_build.c_int, _build.c_int,
                                            _build.c_int]),
    "gather_max_rows": (_build.c_int, [_build.c_int, _build.c_int]),
}
# The modes' numbers in gather.cu.
SIMS, SQUARE, ESICP, TA = 0, 1, 2, 3


def library():
    return _build.load("gather", _SIG)


def scratch(lib, ids, dim: int, mode: int, setting: int = 0):
    """The plan's scratch for one launch at tile ``setting`` (bytes from
    the library; a smaller tile has more tiles, so more scratch): per tile
    of documents a bitmap of its ids, their ranks and list, and every live
    slot's index into that list."""
    import torch

    b, p = ids.shape
    n = lib.gather_scratch_bytes(b, p, dim, mode, setting)
    if n < 0:
        raise ValueError(f"gather.cu has no tile setting {setting}")
    return torch.empty((n,), dtype=torch.uint8, device=ids.device)


def launch(ids, vals, means_t, dim: int, t_th: float, v_th: float, rho12, y,
           sims, counts, *, setting: int = 0) -> None:
    """Launch on the current stream at tile ``setting`` (0-7,
    ``gather_setting_launch``; the autotuner picks it); operands are
    checked by kernels/ops."""
    lib = library()
    b, p = ids.shape
    k = means_t.shape[1]
    rc = lib.gather_setting_launch(
        ESICP, setting, ids.data_ptr(), vals.data_ptr(), means_t.data_ptr(),
        b, p, dim, k, float(t_th), float(v_th), None, rho12.data_ptr(),
        y.data_ptr(), sims.data_ptr(),
        None if counts is None else counts.data_ptr(),
        scratch(lib, ids, dim, ESICP, setting).data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "gather", rc)


def launch_ta(ids, vals, means_t, dim: int, t_th: float, v_ta, rho12, y,
              sims, counts) -> None:
    """The per-row-threshold variant on the current stream."""
    lib = library()
    b, p = ids.shape
    k = means_t.shape[1]
    rc = lib.esicp_gather_ta_launch(
        ids.data_ptr(), vals.data_ptr(), means_t.data_ptr(), b, p, dim, k,
        float(t_th), v_ta.data_ptr(), rho12.data_ptr(), y.data_ptr(),
        sims.data_ptr(), None if counts is None else counts.data_ptr(),
        scratch(lib, ids, dim, TA).data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "gather", rc)
