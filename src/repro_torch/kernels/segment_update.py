"""CUDA kernel: update-step cluster sums (paper Alg. 6 lines 2–5).

Replaces ``repro/kernels/segment_update.py:segment_update_pallas``
(``_update_kernel``): λ[k,d] = Σ_b [assign_b = k]·x_b[d], written here in
the transposed (D, K) layout, so the new means_t is λ normalised in place —
never a 20 GB transpose at the NYT widths.

Design: term-major.  A fit's documents do not change between iterations,
only ``assign`` does, so the documents turn their (N, P) tuple rows into a
term-major layout once (``SparseDocs.by_term``, built by
:func:`repro_torch.sparse.matrix.term_major` on first use and kept; one
stable sort of the flattened ids, set-up and not the ported kernel): each
term's postings (row, value) in (row, slot) order, dead slots dropped.
``ops.segment_update`` takes the documents, so the layout it walks is
always their own.  The kernel
(``csrc/segment_update.cu``) runs one block per row d of λ_t, the longest
posting lists first: it sums the row in shared memory, reading
``assign[row]`` per posting, and writes the whole row once with 16-byte
stores.  So a call allocates λ_t with ``torch.empty``, forms no keys,
sorts nothing, compacts nothing and never waits on the host.  Each λ_t
entry adds its tuples in (row, slot) order from +0, with no fp32 atomics:
the order of the CPU's sequential ``index_add_`` and of ``repro``'s
scatter, so the sums are bitwise repeatable and equal to the plain
version's.  Plain version: :func:`repro_torch.kernels.ref.segment_update`
(row-major; the CPU never builds the layout).

``init`` (the streaming fit's chunks after the first): λ_t is updated in
place, and a term with no posting in the chunk is not touched.  A term
with more postings than an eighth of its tile's columns loads its tile
from λ_t instead of zeroing it (its postings touch most of the row); every
other term gets one warp and no tile: the lane that owns a column reads
λ_t[d, c] from global memory, adds its peers' values in posting order and
writes the cell back.  So the chunked λ_t is the resident one bit for bit
(the same additions in the same order), with no third (D, K) matrix for
an ``init + λ`` sum.  Its bytes: the chunk's postings and assignments
read, each touched (term, cluster) cell read and written.

What bounds it on the card: bytes.  λ_t is written once (D·K·4 bytes,
19.8 GB at the NYT widths) against nnz·8 bytes of postings, the gathered
assignments, ``ptr`` and ``order`` read once.  The TPU kernel's one-hot
MXU matmul has no counterpart.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_update as plain  # noqa: F401

_SIG = {
    "segment_update_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.c_int, _build.c_int, _build.ptr, _build.ptr]),
    "segment_update_accumulate_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.c_int, _build.c_int, _build.c_longlong, _build.ptr,
        _build.ptr]),
}


def launch(by_term, assign, lam_t, *, accumulate: bool = False) -> None:
    """Launch on the current stream over a
    :class:`repro_torch.sparse.matrix.TermMajor`; ``lam_t`` (D, K) is
    written whole, or with ``accumulate`` added to in place (the rows of
    terms with postings only)."""
    lib = _build.load("segment_update", _SIG)
    d, k = lam_t.shape
    args = [by_term.ptr.data_ptr(), by_term.rows.data_ptr(),
            by_term.vals.data_ptr(), by_term.order.data_ptr(),
            assign.data_ptr(), d, k]
    if accumulate:
        rc = lib.segment_update_accumulate_launch(
            *args, by_term.rows.numel(), lam_t.data_ptr(),
            _build.stream_ptr(lam_t.device))
    else:
        rc = lib.segment_update_launch(*args, lam_t.data_ptr(),
                                       _build.stream_ptr(lam_t.device))
    _build.check(lib, "segment_update", rc)
