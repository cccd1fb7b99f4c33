"""CUDA kernel: fused ES upper bound + survivor mask + |Z_i| count.

Replaces ``repro/kernels/esicp_filter.py:esicp_filter_pallas``
(``_filter_kernel``):

    ub[b,k]   = rho12 + y·v_th
    mask[b,k] = (ub > rho_max[b]) & col_ok[b,k]
    count[b]  = Σ_k mask

Source: ``csrc/esicp_filter.cu``; plain version:
:func:`repro_torch.kernels.ref.esicp_filter`.

What bounds it on the card: bytes — it reads rho12, y (fp32) and col_ok
(one byte) and writes mask (one byte) per pair, two operations per pair.
One block per row streams the row coalesced and reduces the row's count in
registers and shared memory, so neither the bound nor the count goes back
to device memory.  Written in CUDA rather than Triton so the port's five
kernels share one build route.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import esicp_filter as plain  # noqa: F401

_SIG = {
    "esicp_filter_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.c_float,
        _build.c_int, _build.c_int, _build.ptr, _build.ptr, _build.ptr]),
}


def launch(rho12, y, rho_max, col_ok, v_th: float, mask, count) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = _build.load("esicp_filter", _SIG)
    b, k = rho12.shape
    rc = lib.esicp_filter_launch(
        rho12.data_ptr(), y.data_ptr(), rho_max.data_ptr(), col_ok.data_ptr(),
        float(v_th), b, k, mask.data_ptr(), count.data_ptr(),
        _build.stream_ptr(rho12.device))
    _build.check(lib, "esicp_filter", rc)
