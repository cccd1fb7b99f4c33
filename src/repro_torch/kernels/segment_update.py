"""CUDA kernel: update-step cluster sums (paper Alg. 6 lines 2–5).

Replaces ``repro/kernels/segment_update.py:segment_update_pallas``
(``_update_kernel``): λ[k,d] = Σ_b [assign_b = k]·x_b[d], written here in
the transposed (D, K) layout, so the new means_t is λ normalised in place —
never a 20 GB transpose at the NYT widths.

Design: the wrapper (kernels/ops.py) drops dead slots and rows whose
assignment lies outside [0, K), forms each live tuple's flat output index
``id·K + assign`` (int64), and sorts those keys stably with ``torch.sort``,
so equal keys keep their row order.  The kernel (``csrc/segment_update.cu``)
is a segmented reduction: the head of each run of equal keys sums the run
in order and stores it.  No fp32 atomics, so the sums are deterministic and
bitwise repeatable, and each is taken in row order — ``repro``'s scatter
order.  Duplicate ids within a row need no precondition: they are equal
keys and add up in slot order.  Plain version:
:func:`repro_torch.kernels.ref.segment_update`.

What bounds it on the card: bytes.  λ must be written once (D·K·4 bytes,
19.8 GB at the NYT widths, the zero fill included) against nnz tuples read;
the sort of the nnz keys and the scattered stores come on top.  The TPU
kernel's one-hot MXU matmul has no counterpart.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_update as plain  # noqa: F401

_SIG = {
    "segment_update_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.c_longlong, _build.ptr, _build.ptr]),
}


def launch(keys, vals, lam_t) -> None:
    """Launch on the current stream over sorted int64 ``keys`` and their
    ``vals``; ``lam_t`` is zeroed by the caller."""
    lib = _build.load("segment_update", _SIG)
    rc = lib.segment_update_launch(keys.data_ptr(), vals.data_ptr(),
                                   keys.numel(), lam_t.data_ptr(),
                                   _build.stream_ptr(keys.device))
    _build.check(lib, "segment_update", rc)
