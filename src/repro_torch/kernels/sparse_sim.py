"""CUDA kernel: sparse-object × mean-index similarity.

Replaces ``repro/kernels/sparse_sim.py:sparse_sim_pallas`` (``_sim_kernel``
with the shared ``_densify`` / ``_densify_pair`` / ``_slab`` helpers):
sims[b,k] = x_b·μ_k for all pairs, optionally counts[b,k] = Σ_p live·[m>0].
It carries ``classify_docs`` and the ``mivi``, ``icp``, ``bounds``,
``sketch`` and ``cs-icp`` fits.

Source: ``csrc/gather.cu`` (template ``gather_kernel<kSims>``, the same
kernel as :mod:`repro_torch.kernels.esicp_gather` with the region
accumulators compiled out); plain version:
:func:`repro_torch.kernels.ref.sparse_sim`.

What bounds it on the card: one contiguous K-row read of means_t per live
tuple, the high-df rows served from L2 — bandwidth, not the nnz·K fp32
FMAs.  The TPU's densify-then-MXU slab, its occupancy map and cached head
slabs have no counterpart: the gather touches only the rows the tuples
name.  fp32 throughout, no TF32.

The ``square`` variant (``gather_kernel<kSquare>``) squares each gathered
value before the product, v·m² — CS-ICP's tail sum of squares.  ``repro``
passes ``means_t * means_t`` to its kernel, a third (D, K) matrix; here no
such matrix exists, and the bits equal sparse_sim over it.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.esicp_gather import library
from repro_torch.kernels.ref import sparse_sim as plain  # noqa: F401


def launch(ids, vals, means_t, dim: int, sims, counts, *,
           square: bool = False) -> None:
    """Launch on the current stream; operands are checked by kernels/ops."""
    lib = library()
    b, p = ids.shape
    k = means_t.shape[1]
    rc = lib.sparse_sim_launch(
        ids.data_ptr(), vals.data_ptr(), means_t.data_ptr(), b, p, dim, k,
        int(square), sims.data_ptr(),
        None if counts is None else counts.data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "gather", rc)
