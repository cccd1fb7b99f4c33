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
hd 256 full causal that is 6.9·10^10 operations against 134 MB of q, k, v
and output (0.04 ms at 3.35 TB/s), so operations.  In fp32 on the CUDA
cores (67 TFLOP/s) that is 1.026 ms, 0.240 ms with a 512-token window.
One TF32 product on the tensor cores (495 TFLOP/s) keeps 11 significant
bits of each operand, an error near 2^-11 of a score that would miss the
2e-5 tolerance.  So each product runs in three TF32 passes (split-TF32:
x = hi + lo, both TF32; lo·hi + hi·lo + hi·hi drops only lo·lo, about
2^-22): 3 × 6.9·10^10 operations at 495 TFLOP/s, 0.417 ms full causal and
0.098 ms at window 512, the bound of the split work.  With scores ≈ 30
the tensor cores' truncating adds are what costs accuracy, not the
dropped lo·lo: plain adds of the score's chunks left up to 3e-5 of error
against float64, a compensated sum of them up to 2e-5 with or without
lo·lo (``scripts/flash_probe.py``), so the kernel runs three passes.

The TPU kernel used 128 × 128 blocks in VMEM on the MXU and streamed
every key block, masked or not.  Here a block owns 64 query rows in four
groups of 16 (the M of ``mma.sync`` m16n8k8) and walks 32-key tiles that
two cp.async stages bring in ahead of the arithmetic.  A group is one
warp, or at hd 256 two warps with half the head dims each, which add
their shares of the scores through shared memory and keep half of the
(16 × hd) accumulator each: 64 registers a thread, not 128, so nothing
spills (222 KB of shared memory, one block of 8 warps an SM).  It skips
the key tiles that lie wholly above the diagonal or outside the window
(about 8× less work for the 512-window layers at S 4096), and a group
skips the arithmetic of a tile none of its rows sees.  The tensor cores
add into their accumulators by truncation, so no chain runs long: the
score's hi·hi terms per 16-dim chunk from zero, its small terms apart,
and each tile's P·V from zero, joined to O by one rounded fmaf.  Operands
are split as they are read from shared memory, whose row strides leave
no bank conflict.

Training: :class:`FlashAttention` is the autograd Function that
``kernels/ops`` routes CUDA operands that need a gradient through.  Its
forward is this kernel with each row's log-sum-exp written beside the
output (``flash_attention_lse_launch``; serving's launches write none);
its backward is ``csrc/flash_attention_bwd.cu``, plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd`.  ``repro`` has no
backward kernel: it differentiates its jnp attention
(``models/layers.py:_attn_core``), whose gradient the backward computes.
The backward is bound by its operations (10·hd a live pair) and runs
them as the forward does, split-TF32 ``mma.sync`` on the tensor cores
(at hd 16 and 32, where that misses autograd's accuracy, fp32 fused
multiply-adds on the CUDA cores).
Each row's normaliser and D need the whole row before any dS, which
would have the scores and dP computed two or three times (up to 18·hd a
pair); this design computes them once: three launches, no atomics, so
two runs give the same bits.
The first, by query tiles, writes P~ = exp(s - lse) and dP of every live
(64 queries × 32 keys) block to a scratch (:func:`bwd_scratch`, 8 bytes
a live pair, at most 1 GiB unless one head needs more: the launches run
over slices of heads) and sums each row's normaliser and D in double; the second,
by key tiles, reads them back for dv = Pᵀ·dO and dk = dSᵀ·q; the third,
by query tiles, for dq = dS·k.  Why the normaliser and D are its own sums,
and the measured split of its time, is in the source's note.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as plain  # noqa: F401
from repro_torch.kernels.ref import flash_attention_bwd as plain_bwd  # noqa: F401

# Head dims the kernel is instantiated for.  ``kernels/ops`` runs any
# other head dim up to 256 on the next of them, q, k and v padded with
# zero columns: they add exact zeros to every score and give zero output
# columns, which it slices off.
HEAD_DIMS = (16, 32, 64, 128, 256)

_SIG = {
    "flash_attention_lse_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.ptr,
        _build.c_int, _build.c_int, _build.c_int, _build.c_int, _build.c_int,
        _build.c_int, _build.c_float, _build.ptr]),
    "flash_attention_resources": (_build.c_int, [
        _build.c_int, _build.ptr, _build.ptr]),
}
_BWD_SIG = {
    "flash_attention_bwd_launch": (_build.c_int, [
        *[_build.ptr] * 9, *[_build.c_int] * 6, _build.c_float,
        _build.ptr]),
    "flash_attention_bwd_scratch_floats": (_build.c_longlong, [
        *[_build.c_int] * 4]),
    "flash_attention_bwd_resources": (_build.c_int, [
        _build.c_int, _build.c_int, _build.ptr, _build.ptr]),
}

# The backward's three launches, in order (``bwd_resources``).
BWD_KERNELS = ("flash_bwd_scores", "flash_bwd_kv", "flash_bwd_q")


def library():
    return _build.load("flash_attention", _SIG)


def bwd_library():
    return _build.load("flash_attention_bwd", _BWD_SIG)


def resources(hd: int) -> tuple[int, int]:
    """(dynamic shared bytes, blocks an SM) of the forward's instantiation
    for hd."""
    import ctypes

    lib = library()
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = lib.flash_attention_resources(hd, ctypes.byref(smem),
                                       ctypes.byref(blocks))
    _build.check(lib, "flash_attention", rc)
    return smem.value, blocks.value


def bwd_resources(hd: int) -> dict[str, tuple[int, int]]:
    """{launch: (dynamic shared bytes, blocks an SM)} of the backward's
    three launches at hd."""
    import ctypes

    lib = bwd_library()
    out = {}
    for which, name in enumerate(BWD_KERNELS):
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        rc = lib.flash_attention_bwd_resources(
            hd, which, ctypes.byref(smem), ctypes.byref(blocks))
        _build.check(lib, "flash_attention_bwd", rc)
        out[name] = (smem.value, blocks.value)
    return out


def bwd_scratch(bh: int, sq: int, sk_real: int, window: int, device):
    """The backward's float32 scratch: P~ and dP of every storage block
    the mask leaves live, then each row's D and Z, for one slice of heads
    (8 bytes a live pair and some: 0.55 GB at (8, 4096, 256) full causal,
    0.15 GB at window 512).  The launches run over slices of as many heads
    as fit in 1 GiB, so it stays within that whatever ``bh``, unless one
    head alone needs more: under full causal attention a head takes
    ≈ 4·Sq² bytes, 1.08 GB at Sq 16,384 and 4.3 GB at 32,768."""
    n = bwd_library().flash_attention_bwd_scratch_floats(bh, sq, sk_real,
                                                         window)
    return torch.empty(n, dtype=torch.float32, device=device)


def padded_head_dim(hd: int) -> int:
    """The instantiation a head dim runs on: the least of HEAD_DIMS at or
    above it.  Raises above the largest."""
    for h in HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(f"head dim {hd} above the kernel's largest, "
                     f"{HEAD_DIMS[-1]}")


def launch(q, k, v, window: int, sk_real: int, out, scale: float,
           lse=None) -> None:
    """flash_attention on the current stream; operands are checked by
    kernels/ops.  ``scale`` multiplies the scores: 1/sqrt(hd) of the
    unpadded head dim when the operands carry zero columns.  ``lse``
    (BH, Sq) float32, if given, gets each row's log-sum-exp."""
    lib = library()
    bh, sq, hd = q.shape
    rc = lib.flash_attention_lse_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, sq, k.shape[1], hd,
        sk_real, window, float(scale), _build.stream_ptr(q.device))
    _build.check(lib, "flash_attention", rc)


def launch_bwd(q, k, v, lse, do, window: int, sk_real: int, scale: float,
               dq, dk, dv, scratch) -> None:
    """The backward's three launches on the current stream: q, do, dq
    (BH, Sq, hd), k, v, dk, dv (BH, Sk, hd), lse (BH, Sq) and the scratch
    (:func:`bwd_scratch`), all float32, contiguous, at an instantiated
    hd."""
    lib = bwd_library()
    bh, sq, hd = q.shape
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(), bh, sq, k.shape[1], hd, sk_real,
        window, float(scale), _build.stream_ptr(q.device))
    _build.check(lib, "flash_attention_bwd", rc)


def attend(q, k, v, window: int, sk_real: int, scale: float, lse=None):
    """A new (BH, Sq, hd) float32 output from one launch counted as
    ``flash_attention`` in ``ops.LAUNCHES`` (see :func:`launch`); an empty
    operand launches nothing and gives zeros (and ``lse`` as it was)."""
    from repro_torch.kernels import ops

    bh, sq, hd = q.shape
    if not (bh and sq and k.shape[1]):
        return torch.zeros((bh, sq, hd), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((bh, sq, hd), dtype=torch.float32, device=q.device)
    launch(q, k, v, window, sk_real, out, scale, lse)
    ops.LAUNCHES["flash_attention"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """flash_attention with its hand-written backward, for CUDA operands
    that need a gradient (``kernels/ops`` checks them, zero-pads hd to an
    instantiation and routes them here).  q, k, v and lse are saved for
    the backward.  Counts ``flash_attention`` per forward (a checkpointed
    layer's recompute included) and ``flash_attention_bwd`` per backward
    in ``ops.LAUNCHES``."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, sk_real: int, scale: float):
        lse = torch.full(q.shape[:2], torch.inf, device=q.device)
        out = attend(q, k, v, window, sk_real, scale, lse)
        ctx.save_for_backward(q, k, v, lse)
        ctx.window, ctx.sk_real, ctx.scale = window, sk_real, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        from repro_torch.kernels import ops

        q, k, v, lse = ctx.saved_tensors
        bh, sq, _ = q.shape
        run = bool(bh and sq and k.shape[1])
        dq, dk, dv = ((torch.empty_like if run else torch.zeros_like)(t)
                      for t in (q, k, v))
        if run:
            scratch = bwd_scratch(bh, sq, ctx.sk_real, ctx.window,
                                  q.device)
            launch_bwd(q, k, v, lse, dout.contiguous(), ctx.window,
                       ctx.sk_real, ctx.scale, dq, dk, dv, scratch)
            ops.LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None
