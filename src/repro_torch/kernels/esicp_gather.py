"""CUDA kernel: fused ES-filter gathering phase (paper Alg. 3 / G_0, G_1).

Replaces ``repro/kernels/esicp_gather.py:esicp_gather_pallas``
(``_gather_kernel``).  One pass over the object tuples produces, per
(object b, centroid k):

    rho12[b,k] = Σ_{s<t_th} u·v + Σ_{s≥t_th, v≥v_th} u·v     (exact part)
    y[b,k]     = Σ_{s≥t_th, v<v_th} u                         (Region-3 mass)
    sims[b,k]  = x_b·μ_k                                      (exact sims)
    counts[b,k]= Σ live·[v > 0 ∧ exact]                       (Mult, optional)

Source: ``csrc/gather.cu`` (template ``gather_kernel<kEsicp>``); plain
version: :func:`repro_torch.kernels.ref.esicp_gather`.

What bounds it on the card.  The TPU kernel densified each (B_blk, D_blk)
slab and fed the MXU: at the NYT widths (D 495,126, K 10,000) that is a
B×D×K product.  Here the mean-inverted index is walked directly: every live
tuple (id, u) reads the contiguous row means_t[id, k0:k0+1024] and updates
registers, so the work is nnz·K multiply-adds (four accumulators) and the
traffic is one K-row read per tuple.  Zipf's law makes the high-df rows
hot, and L2 (50 MB) holds some 1,250 such rows of 40 KB, so most row reads
are L2 hits; the kernel is bound by L2/device-memory bandwidth of those row
reads, not by the fp32 FMAs.  The shared (t_th, v_th) keep every thread of a
block on the same path through the tuple loop.  No tensor cores, no TF32:
fp32 stays fp32.

The ``ta`` variant (``gather_kernel<kTa>``, :func:`launch_ta`) serves
TA-ICP (paper App. F-A): each document brings its own value threshold
v_ta[b] = ρ_self / ||x||_1, read once per document in place of the shared
v_th, so a block still takes one path per document.  ``repro`` has no
Pallas kernel for it (its per-object threshold does not fit the
densified slab) and runs the TAAT scan, ``reference_scan(mode="ta")``.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import esicp_gather as plain  # noqa: F401

_SIG = {
    "esicp_gather_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_float, _build.c_float,
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr]),
    "esicp_gather_ta_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_float, _build.ptr,
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr]),
    "sparse_sim_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_int, _build.ptr, _build.ptr,
        _build.ptr]),
    "gather_max_rows": (_build.c_int, []),
}


def library():
    return _build.load("gather", _SIG)


def launch(ids, vals, means_t, dim: int, t_th: float, v_th: float, rho12, y,
           sims, counts) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = library()
    b, p = ids.shape
    k = means_t.shape[1]
    rc = lib.esicp_gather_launch(
        ids.data_ptr(), vals.data_ptr(), means_t.data_ptr(), b, p, dim, k,
        float(t_th), float(v_th), rho12.data_ptr(), y.data_ptr(),
        sims.data_ptr(), None if counts is None else counts.data_ptr(),
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
        _build.stream_ptr(ids.device))
    _build.check(lib, "gather", rc)
