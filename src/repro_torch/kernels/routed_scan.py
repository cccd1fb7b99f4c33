"""CUDA kernel: the routed scan of a two-level model.

``repro`` computes it in plain JAX outside any Pallas kernel
(``repro/cluster/classify.py:_routed_fused``, the ``lax.scan`` over the P
tuple slots of (B, n_probe·cmax) gathers from ``means_ext``, the -inf mask
on dead slots, the argmax): in eager PyTorch that would be P × 3 launches
per batch.  Here it is one kernel: per document, the similarities to the
fine centroids of its probed cells (``cells`` (B, n_probe) int32, each
cell's block ``[starts[c], starts[c] + sizes[c])`` of ``means_t``'s
columns, ``cmax`` the largest cell), and the first maximum in candidate
order (probe rank, then slot).  Returns assign (global fine id, int32),
best (float32) and scored (K_c + Σ probed sizes, int32).

Source: ``csrc/routed_scan.cu``; plain version:
:func:`repro_torch.kernels.ref.routed_scan`.  Both sum each candidate's
live slots (the first ``nnz``, v != 0) in ascending order with rounded
products and adds, the flat ``sparse_sim``'s arithmetic, so the two agree
bit for bit and a winner's similarity is the flat classify's.

What bounds it on the card: the gathered means — each live tuple reads
n_probe·cmax consecutive floats of its term's row (one multiply-add
each), and the rows of the probed cells that the batch's documents name
come from device memory.  One block per document and one thread per
candidate column, a simple design: rows shared across the documents of a
batch are not staged.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import routed_scan as plain  # noqa: F401

_SIG = {
    "routed_scan_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr, _build.c_int, _build.c_int, _build.c_int,
        _build.c_int, _build.c_int, _build.c_int, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr]),
}


def launch(ids, vals, nnz, means_t, cells, starts, sizes, cmax: int,
           assign, best, scored) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = _build.load("routed_scan", _SIG)
    b, p = ids.shape
    rc = lib.routed_scan_launch(
        ids.data_ptr(), vals.data_ptr(), nnz.data_ptr(), means_t.data_ptr(),
        cells.data_ptr(), starts.data_ptr(), sizes.data_ptr(), b, p,
        means_t.shape[1], cells.shape[1], int(cmax), starts.shape[0],
        assign.data_ptr(), best.data_ptr(), scored.data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "routed_scan", rc)
