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

What bounds it on the card.  Reading the gates once and writing hs once is
20·B·S·D bytes (125.8 MB at B 2, S 4,096, D 768, 0.038 ms at 3.35 TB/s),
but no launch finishes before S dependent steps of its state.  Those steps
are short: m' = max(f + m, i) and c, n = f_e·(c, n) + (u, i_e), two
operations each.  The rest of a step (tanh, three exponentials, two IEEE
quotients, some 75 instructions) feeds no later step, yet one thread a
channel used to issue all of it in step order on one warp.  So a block of
CHANNELS channels of one row now splits the roles: two chain warps run
only the carried chains (pass m; pass c, n), WARPS - 2 worker warps copy
the gates in (cp.async, two phases ahead), compute the exponentials and
tanh before the chains' pass c, n and the sigmoid and output quotient
after it, in tiles of TILE steps through rings in shared memory, one block
barrier a tile.  Twelve channels a block put xlstm-125m's prefill on 128
of the 132 SMs.  What bounds it now is the workers: their arithmetic and
their gate copies, which overlap only in part (``scripts/slstm_probe.py``
times the workers alone, the chains alone and the chains' dependent
operations alone).  It stays one launch, so a decode step stays one
launch, and sequential: a parallel prefix would reassociate rounded sums.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slstm_scan as plain  # noqa: F401

# The block's geometry: csrc/slstm_scan.cu's kChannels, kWarps and kTile (a
# CPU test holds these and WALK_BELOW equal to the source's).  A block
# takes CHANNELS channels of one row, so the grid is B · ceil(D / CHANNELS)
# blocks of 32 · WARPS threads.
CHANNELS = 12
WARPS = 12
TILE = 80
# Scans of fewer steps (a decode step) launch csrc/slstm_scan.cu's walk of a
# thread a channel instead of the tiles: its kWalkBelow.
WALK_BELOW = 64

_SIG = {
    "slstm_scan_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.c_int,
        _build.c_int, _build.c_int, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr]),
    "slstm_scan_resources": (_build.c_int, [_build.ptr, _build.ptr]),
}


def blocks(b: int, d: int, s: int) -> int:
    """Blocks of a launch over B rows of D channels and S steps (the walk's
    are one warp of 32 channels)."""
    return b * -(-d // (32 if s < WALK_BELOW else CHANNELS))


def resources() -> tuple[int, int]:
    """(dynamic shared bytes a block, blocks an SM) of the kernel."""
    import ctypes

    lib = _build.load("slstm_scan", _SIG)
    smem, per_sm = ctypes.c_int(), ctypes.c_int()
    rc = lib.slstm_scan_resources(ctypes.byref(smem), ctypes.byref(per_sm))
    _build.check(lib, "slstm_scan", rc)
    return smem.value, per_sm.value


def launch(gates, c0, n0, m0, hs, c, n, m) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = _build.load("slstm_scan", _SIG)
    b, s, d4 = gates.shape
    rc = lib.slstm_scan_launch(
        gates.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(), b, s,
        d4 // 4, hs.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
        _build.stream_ptr(gates.device))
    _build.check(lib, "slstm_scan", rc)
