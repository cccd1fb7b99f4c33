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

Training: :class:`SlstmScan` is the autograd Function that ``kernels/ops``
routes CUDA operands that need a gradient through; its backward is
``csrc/slstm_scan_bwd.cu`` (plain version
:func:`repro_torch.kernels.ref.slstm_scan_bwd`, the reverse loop, which it
matches bit for bit), one C call of two launches.  The forward runs again,
the tiles above in a states mode that stores the state after every step
(c, n, m) in a scratch of 12·B·S·D bytes instead of hs.  Then the
adjoints walk the tiles back in time with the forward's split of roles: a
block of BWD_CHANNELS channels, chain warp A carrying gc and gn (an add
and a product each), chain warp B carrying gm (two differences, a product
and a sum), BWD_WARPS - 2 workers for the elementwise rest in three
stages, each tile's operands brought into rings of shared memory by
tensor copies (TMA) that one thread issues.  Of the two ways to run the
forward again, a second launch with the states through device memory
was built, not checkpoints a tile and a recompute inside the backward's
blocks: it is the forward's tiles in another mode, bit for bit by
construction, where the recompute would need two more chain warps and
their rings in blocks whose shared memory the adjoints already fill.  It
costs the scratch's round trip and a third of the backward's time
(PERF.md §6); the recompute was not built or measured.  Below
BWD_WALK_BELOW steps one launch of a thread a channel runs both, the
backward's first design.  ``repro`` differentiates its ``lax.scan`` with
JAX's rules (``jnp.maximum`` splits a tie's gradient in half), which the
adjoints follow.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slstm_scan as plain  # noqa: F401
from repro_torch.kernels.ref import slstm_scan_bwd as plain_bwd  # noqa: F401

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
# The backward's adjoint tiles: csrc/slstm_scan_bwd.cu's kChannels, kWarps,
# kTile and kWalkBelow in its namespace bwd (a CPU test holds them equal).
# Its grid is B · ceil(D / BWD_CHANNELS) blocks of 32 · BWD_WARPS threads;
# below BWD_WALK_BELOW steps it runs the walk of a thread a channel.
BWD_CHANNELS = 12
BWD_WARPS = 8
BWD_TILE = 64
BWD_WALK_BELOW = 64

_SIG = {
    "slstm_scan_launch": (_build.c_int, [
        _build.ptr, _build.ptr, _build.ptr, _build.ptr, _build.c_int,
        _build.c_int, _build.c_int, _build.ptr, _build.ptr, _build.ptr,
        _build.ptr, _build.ptr]),
    "slstm_scan_resources": (_build.c_int, [_build.ptr, _build.ptr]),
}
_BWD_SIG = {
    "slstm_scan_bwd_launch": (_build.c_int, [
        *[_build.ptr] * 8, _build.c_int, _build.c_int, _build.c_int,
        *[_build.ptr] * 6]),
    "slstm_scan_bwd_resources": (_build.c_int, [_build.ptr, _build.ptr]),
}


def blocks(b: int, d: int, s: int) -> int:
    """Blocks of a launch over B rows of D channels and S steps (the walk's
    are one warp of 32 channels)."""
    return b * -(-d // (32 if s < WALK_BELOW else CHANNELS))


def bwd_blocks(b: int, d: int, s: int) -> int:
    """Blocks of the backward's adjoint launch (of its one launch, the
    walk, below BWD_WALK_BELOW steps); its forward again has
    ``blocks(b, d, WALK_BELOW)``."""
    return b * -(-d // (32 if s < BWD_WALK_BELOW else BWD_CHANNELS))


def _resources(name: str, sig: dict) -> tuple[int, int]:
    import ctypes

    lib = _build.load(name, sig)
    smem, per_sm = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, f"{name}_resources")(ctypes.byref(smem),
                                           ctypes.byref(per_sm))
    _build.check(lib, name, rc)
    return smem.value, per_sm.value


def resources() -> tuple[int, int]:
    """(dynamic shared bytes a block, blocks an SM) of the kernel."""
    return _resources("slstm_scan", _SIG)


def bwd_resources() -> tuple[int, int]:
    """(dynamic shared bytes a block, blocks an SM) of the backward's
    adjoint tiles."""
    return _resources("slstm_scan_bwd", _BWD_SIG)


def launch(gates, c0, n0, m0, hs, c, n, m) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = _build.load("slstm_scan", _SIG)
    b, s, d4 = gates.shape
    rc = lib.slstm_scan_launch(
        gates.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(), b, s,
        d4 // 4, hs.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
        _build.stream_ptr(gates.device))
    _build.check(lib, "slstm_scan", rc)


def launch_bwd(gates, c0, n0, m0, dhs, dc, dn, dm, states, dgates, dc0,
               dn0, dm0) -> None:
    """The backward on the current stream; all float32 and contiguous,
    ``states`` a (3, B, S, D) scratch."""
    lib = _build.load("slstm_scan_bwd", _BWD_SIG)
    b, s, d4 = gates.shape
    rc = lib.slstm_scan_bwd_launch(
        gates.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
        dhs.data_ptr(), dc.data_ptr(), dn.data_ptr(), dm.data_ptr(), b, s,
        d4 // 4, states.data_ptr(), dgates.data_ptr(), dc0.data_ptr(),
        dn0.data_ptr(), dm0.data_ptr(), _build.stream_ptr(gates.device))
    _build.check(lib, "slstm_scan_bwd", rc)


def scan(gates, c0, n0, m0):
    """(hs, c, n, m), new float32 tensors, from one launch counted as
    ``slstm_scan`` in ``ops.LAUNCHES``; an empty scan launches nothing and
    returns copies of the state.  Operands are checked by kernels/ops."""
    from repro_torch.kernels import ops

    b, s, d4 = gates.shape
    hs = torch.empty((b, s, d4 // 4), dtype=torch.float32,
                     device=gates.device)
    if not (s and b and d4):
        return hs, c0.clone(), n0.clone(), m0.clone()
    c, n, m = (torch.empty_like(c0) for _ in range(3))
    launch(gates, c0, n0, m0, hs, c, n, m)
    ops.LAUNCHES["slstm_scan"] += 1
    return hs, c, n, m


class SlstmScan(torch.autograd.Function):
    """slstm_scan with its hand-written backward, for CUDA operands that
    need a gradient (checked by ``kernels/ops``).  Outputs (hs, c, n, m);
    an output whose gradient is not asked for takes zeros.  Counts
    ``slstm_scan`` per forward (a checkpointed layer's recompute included)
    and ``slstm_scan_bwd`` per backward in ``ops.LAUNCHES``."""

    @staticmethod
    def forward(ctx, gates, c0, n0, m0):
        ctx.save_for_backward(gates, c0, n0, m0)
        return scan(gates, c0, n0, m0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dc, dn, dm):
        from repro_torch.kernels import ops

        gates, c0, n0, m0 = ctx.saved_tensors
        b, s, d4 = gates.shape
        if not (s and b and d4):
            return torch.zeros_like(gates), dc, dn, dm
        dhs, dc, dn, dm = (t.contiguous() for t in (dhs, dc, dn, dm))
        states = torch.empty((3, b, s, d4 // 4), dtype=torch.float32,
                             device=gates.device)
        dgates = torch.empty_like(gates)
        dc0, dn0, dm0 = (torch.empty_like(c0) for _ in range(3))
        launch_bwd(gates, c0, n0, m0, dhs, dc, dn, dm, states, dgates, dc0,
                   dn0, dm0)
        ops.LAUNCHES["slstm_scan_bwd"] += 1
        return dgates, dc0, dn0, dm0
