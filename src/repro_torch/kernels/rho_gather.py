"""CUDA kernel: ρ_self refresh — each object's similarity to its own centroid.

Replaces ``repro/kernels/rho_gather.py:rho_gather_pallas`` (``_rho_kernel``):
ρ[b] = x_b·μ_{assign_b}, 0 when assign_b lies outside [0, K).

The TPU kernel avoided a data-dependent column gather with a one-hot MXU
product over every centroid tile.  On Hopper the gather is direct: one warp
per object, each lane reading means_t[id, assign_b] for its live slots and
a shuffle butterfly folding the lanes (``csrc/rho_gather.cu``).  Plain
version: :func:`repro_torch.kernels.ref.rho_gather`, which repeats the
lane order, so the two agree bit for bit.

What bounds it on the card: bytes — the live tuples (8 bytes each, the
row's first ``nnz`` slots when the caller passes ``nnz``) plus one 4-byte
means entry per live tuple and 12 bytes per object (assignment, length,
ρ).  Each means read is a strided access, a 32-byte sector for 4 useful
bytes; the kernel sorts the objects by centroid first (a counting sort in
the same source, its scratch from the caller), so the objects that share
a sector run together and it comes from device memory about once.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rho_gather as plain  # noqa: F401

_SIG = {
    "rho_gather_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.c_int, _build.c_int, _build.c_int, _build.c_int, _build.ptr,
        _build.ptr, _build.ptr]),
}


def launch(assign, ids, vals, nnz, means_t, dim: int, scratch, out) -> None:
    """Launch on the current stream; operands are checked by kernels/ops.
    ``nnz`` may be None; ``scratch`` holds B + K + 1 int32."""
    lib = _build.load("rho_gather", _SIG)
    b, p = ids.shape
    rc = lib.rho_gather_launch(
        assign.data_ptr(), ids.data_ptr(), vals.data_ptr(),
        None if nnz is None else nnz.data_ptr(), means_t.data_ptr(), b, p,
        dim, means_t.shape[1], scratch.data_ptr(), out.data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "rho_gather", rc)
