"""CUDA kernel: the sLSTM scan over time.

``repro`` computes it in plain JAX outside any Pallas kernel
(``repro/models/ssm.py:slstm_block``, the ``lax.scan`` of ``step``), which
XLA compiles into one loop; written eagerly in torch each step would be
about 17 elementwise launches, some 70,000 per sLSTM layer of a 4,096-token
prefill.  Here the loop is one launch: gates (B, S, 4D) float32 laid out
z | i | f | o, the state (c, n, m) (B, D) float32 -> hs (B, S, D) and the
final (c, n, m).  The prefill starts from c = n = 0, m = -1e30; a decode
step is a launch of S = 1 from the cached state.

Source: ``csrc/slstm_scan.cu``; plain version:
:func:`repro_torch.kernels.ref.slstm_scan`, a Python loop over t.  The
kernel repeats the plain version's operations in its order (rounded
products, sums and quotients, no contracted multiply-add; ``expf`` and
``tanhf`` as torch's CUDA ops), so the two are meant to agree bit for bit
on the card, and a state carried across two launches equals one launch.

What bounds it on the card: the recurrence, not the bytes.  Reading the
gates once and writing hs once is 20·B·S·D bytes (125.8 MB at B 2, S 4,096,
D 768, 0.038 ms at 3.35 TB/s), but each of the S steps depends on the one
before, so no launch finishes before S dependent steps of its state.  One
thread per (b, d) channel walks t with its state in registers; a block is
one warp of 32 channels of one row, so B·D/32 warps (48 at xlstm-125m's
prefill) each sit on an SM of their own, and each loads the gates of the
next 16 steps while it computes the current 16.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slstm_scan as plain  # noqa: F401

# A block's channels (one warp): csrc/slstm_scan.cu's kThreads.
THREADS = 32

_SIG = {
    "slstm_scan_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.c_int,
        _build.c_int, _build.c_int, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr]),
}


def launch(gates, c0, n0, m0, hs, c, n, m) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = _build.load("slstm_scan", _SIG)
    b, s, d4 = gates.shape
    rc = lib.slstm_scan_launch(
        gates.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(), b, s,
        d4 // 4, hs.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
        _build.stream_ptr(gates.device))
    _build.check(lib, "slstm_scan", rc)
