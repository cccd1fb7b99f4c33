"""CUDA kernels: block-vector sketch similarity and document sketches.

``sketch_sim`` replaces ``repro/kernels/sketch_sim.py:sketch_sim_pallas``
(``_sketch_kernel``): (B, S) doc sketches × (S, K) mean sketches ->
(B, K) float32, S ≤ 64.  The ``sketch`` mode's gate and both sparse
pair counts (``_sketch_pairs`` and the Region-3 ``r3_pairs`` of
``bounds-esicp``, products of 0/1 sketches, exact in float32) run through
it.  ``doc_sketch`` has no Pallas counterpart: ``repro`` computes it with
``segment_sum`` outside any kernel.  On the card the torch scatter ops
add with atomics, in an order that may differ from the CPU's, and a
flipped ulp in a sketch can change Mult; so it is a kernel here, with the
CPU's order.

Source: ``csrc/sketch.cu``; plain versions
:func:`repro_torch.kernels.ref.sketch_sim` and
:func:`repro_torch.kernels.ref.doc_sketch`.

What bounds it on the card.  At B 4096, S 64, K 10,000 sketch_sim is
5.2·10^9 floating-point operations (0.078 ms at the 67 TFLOP/s fp32 rate)
against 164 MB of output (0.049 ms at 3.35 TB/s): operations.  The
no-FMA rule that keeps it bit-equal to its plain version makes each
multiply-add two FP32 instructions, so its floor is twice that, 0.157 ms
(and such a loop does not reach the data-sheet FP32 rate).  The TPU kernel was one MXU dot per 128-row block with
S padded to 128 lanes; here one persistent block per SM walks 128 × 128
output tiles, copies each tile's operands (64 KB) into shared memory with
cp.async while the previous tile computes, and each thread keeps an
8 × 8 register micro-tile fed by 16-byte shared loads, so the FP32 pipe
sets the pace (no tensor cores, no TF32).  A warp skips an s whose x is
zero in all 16 of its rows, exactly (finite mean sketches: ±0 products
change no bit); that cuts the Region-3 tail product of ``bounds-esicp``
to its groups at or past t_th.  doc_sketch reads the (B, P) tuples once
(14 MB at B 4096, P 429: 0.0045 ms): bytes.  A block stages 16
documents' tuples in shared memory, each tuple's group computed once by
a multiply-high reciprocal of g (:func:`group_reciprocal`), and 8
threads per document add each their own slots in p order; each of them
reads every tuple of its document, which makes that walk, not the
copy, the larger part of the kernel's time
(``scripts/small_kernel_probe.py`` times the parts).
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import doc_sketch as plain_doc_sketch  # noqa: F401
from repro_torch.kernels.ref import sketch_sim as plain  # noqa: F401

# Largest sketch width the kernel stages in shared memory.
MAX_S = 64

_SIG = {
    "sketch_sim_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.c_int, _build.c_int, _build.c_int,
        _build.ptr, _build.ptr]),
    "doc_sketch_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.c_int, _build.c_int, _build.c_uint,
        _build.c_int, _build.c_int, _build.ptr, _build.ptr]),
    "sketch_max_rows": (_build.c_int, []),
}


def library():
    return _build.load("sketch", _SIG)


def launch(sk_docs, sketch_t, out) -> None:
    """sketch_sim on the current stream; operands are checked by
    kernels/ops."""
    lib = library()
    b, s = sk_docs.shape
    rc = lib.sketch_sim_launch(sk_docs.data_ptr(), sketch_t.data_ptr(), b, s,
                               sketch_t.shape[1], out.data_ptr(),
                               _build.stream_ptr(sk_docs.device))
    _build.check(lib, "sketch", rc)


def group_reciprocal(g: int) -> tuple[int, int]:
    """(magic, shift) with (n * magic) >> shift == n // g for every
    0 <= n < 2**31, magic < 2**32: the doc_sketch kernel's division.

    shift = 31 + ceil(log2 g), magic = ceil(2**shift / g).  Writing
    n = q·g + r, n·magic / 2**shift = q + (r + n·e / 2**shift) / g with
    e = magic·g - 2**shift < g <= 2**(shift - 31), so the added fraction
    stays below (r + 1) / g <= 1.
    """
    if not 1 <= g < 2**31:
        raise ValueError(f"group width {g} must lie in [1, 2**31)")
    shift = 31 + (g - 1).bit_length()
    return -(-(1 << shift) // g), shift


def launch_doc_sketch(ids, vals, group_width: int, out) -> None:
    """doc_sketch on the current stream; operands are checked by
    kernels/ops."""
    lib = library()
    b, p = ids.shape
    magic, shift = group_reciprocal(group_width)
    rc = lib.doc_sketch_launch(ids.data_ptr(), vals.data_ptr(), b, p, magic,
                               shift, out.shape[1], out.data_ptr(),
                               _build.stream_ptr(ids.device))
    _build.check(lib, "sketch", rc)
