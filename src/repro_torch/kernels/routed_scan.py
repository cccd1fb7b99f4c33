"""CUDA kernel: the routed scan of a two-level model.

``repro`` computes it in plain JAX outside any Pallas kernel
(``repro/cluster/classify.py:_routed_fused``, the ``lax.scan`` over the P
tuple slots of (B, n_probe·cmax) gathers from ``means_ext``, the -inf mask
on dead slots, the argmax): in eager PyTorch that would be P × 3 launches
per batch.  Here it is one source of three launches: per document, the
similarities to the fine centroids of its probed cells (``cells``
(B, n_probe) int32, each cell's block ``[starts[c], starts[c] +
sizes[c])`` of ``means_t``'s columns, ``cmax`` the largest cell), and the
first maximum in candidate order (probe rank, then slot).  Returns
assign (global fine id, int32), best (float32) and scored (K_c + Σ
probed sizes, int32).

Source: ``csrc/routed_scan.cu``; plain version:
:func:`repro_torch.kernels.ref.routed_scan`.  Both sum each candidate's
live slots (the first ``nnz``, v != 0) in ascending order with rounded
products and adds, the flat ``sparse_sim``'s arithmetic, so the two agree
bit for bit and a winner's similarity is the flat classify's.

What bounds it on the card: the gathered means.  Each live tuple reads
its probed cells' blocks of its term's row (one multiply and one add a
float); the distinct (term, cell) blocks that the batch names come from
device memory, and each (document, probe) pair's reads of them from L2.
The kernel groups the batch by cell on the device (a counting sort in a
one-block plan launch), then a block per (document, probe rank, strip of
128 columns of its cell) walks the document's staged slots with the
gathers of 8 steps in flight (four columns a thread, one 16-byte gather,
when K is a multiple of 4 and ``means_t`` 16-byte aligned; else one), and
a 64-bit ``atomicMax`` per warp on an order-preserving key keeps the
first maximum; a finish launch decodes it.  One call of :func:`launch` is
these three device launches.  Scratch (keys, offsets, the sort and the
blocks' map) comes from the caller's stream.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import routed_scan as plain  # noqa: F401

_SIG = {
    "routed_scan_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr, _build.c_int, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_int, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr, _build.ptr]),
    "routed_scan_scratch_bytes": (_build.c_longlong, [
        _build.c_int, _build.c_int, _build.c_int, _build.c_int]),
}


def launch(ids, vals, nnz, means_t, cells, starts, sizes, cmax: int,
           assign, best, scored) -> None:
    """Launch on the current stream; operands are checked by kernels/ops.
    The scratch is taken from the caching allocator on that stream, so a
    CUDA graph capture holds it."""
    import torch

    lib = _build.load("routed_scan", _SIG)
    b, p = ids.shape
    n_probe, k_c = cells.shape[1], starts.shape[0]
    n = lib.routed_scan_scratch_bytes(b, n_probe, k_c, int(cmax))
    if n < 0:
        raise ValueError(f"routed_scan cannot take B {b}, n_probe {n_probe}, "
                         f"K_c {k_c}, cmax {cmax}")
    scratch = torch.empty((n,), dtype=torch.uint8, device=ids.device)
    rc = lib.routed_scan_launch(
        ids.data_ptr(), vals.data_ptr(), nnz.data_ptr(), means_t.data_ptr(),
        cells.data_ptr(), starts.data_ptr(), sizes.data_ptr(), b, p,
        means_t.shape[1], n_probe, int(cmax), k_c, scratch.data_ptr(),
        assign.data_ptr(), best.data_ptr(), scored.data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "routed_scan", rc)
