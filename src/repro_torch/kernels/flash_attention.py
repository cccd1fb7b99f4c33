"""CUDA kernel: banded-causal flash attention (online softmax).

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``
(``_flash_kernel``): q (BH, Sq, hd) and k/v (BH, Sk, hd) float32, heads
folded into BH by the caller, -> (BH, Sq, hd) float32.  Key k_pos is live
for query q_pos iff k_pos <= q_pos, q_pos - k_pos < window (window < 0:
full causal) and k_pos < sk_real; a row with no live key gives 0.  The
prefill of every attention layer runs it (``models/layers.py:attention``).

Source: ``csrc/flash_attention.cu``; plain version
:func:`repro_torch.kernels.ref.flash_attention` (materialised scores and
softmax), which it matches to rounding, not bit for bit.

What bounds it on the card.  Each live (query, key) pair costs 2·hd
operations for the score and 2·hd for the value product: at BH 8, S 4096,
hd 256 full causal that is 6.9·10^10 fp32 operations (1.03 ms at the
67 TFLOP/s fp32 rate) against 134 MB of q, k, v and output (0.04 ms at
3.35 TB/s), so operations; with a 512-token window 1.7·10^10 (0.25 ms).
The TPU kernel used 128 × 128 blocks in VMEM on the MXU and streamed
every key block, masked or not.  Here hd 256 in fp32 makes a 32-row tile
32 KB, so a block holds 32 query rows and walks 32-key tiles (99 KB of
dynamic shared memory, two blocks per SM), skips the key tiles that lie
wholly above the diagonal or outside the window (about 8× less work for
the 512-window layers at S 4096), and keeps the (32 × hd) accumulator in
registers, 4 rows × hd/32 columns per thread.  fp32 FMAs on the CUDA
cores: a TF32 tensor-core product would miss the 2e-5 tolerance.
"""
from __future__ import annotations

import math

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as plain  # noqa: F401

# Head dims the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128, 256)

_SIG = {
    "flash_attention_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.c_int,
        _build.c_int, _build.c_int, _build.c_int, _build.c_int, _build.c_int,
        _build.c_float, _build.ptr]),
}


def library():
    return _build.load("flash_attention", _SIG)


def launch(q, k, v, window: int, sk_real: int, out) -> None:
    """flash_attention on the current stream; operands are checked by
    kernels/ops."""
    lib = library()
    bh, sq, hd = q.shape
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        k.shape[1], hd, sk_real, window, 1.0 / math.sqrt(hd),
        _build.stream_ptr(q.device))
    _build.check(lib, "flash_attention", rc)
