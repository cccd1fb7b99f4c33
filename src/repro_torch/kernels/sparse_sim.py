"""CUDA kernel: sparse-object × mean-index similarity.

Replaces ``repro/kernels/sparse_sim.py:sparse_sim_pallas`` (``_sim_kernel``
with the shared ``_densify`` / ``_densify_pair`` / ``_slab`` helpers):
sims[b,k] = x_b·μ_k for all pairs, optionally counts[b,k] = Σ_p live·[m>0].
It carries ``classify_docs`` and the ``mivi``, ``icp``, ``bounds``,
``sketch`` and ``cs-icp`` fits.

Source: ``csrc/gather.cu`` (template ``gather_tiled<kSims>``, the same
kernel as :mod:`repro_torch.kernels.esicp_gather` without the region
accumulators); plain version: :func:`repro_torch.kernels.ref.sparse_sim`.

What bounds it on the card: moving the named means rows to the SMs, not
the nnz·K fp32 multiply-adds.  Tiles of 28 documents × 256 columns stage
each distinct row segment of a tile once in shared memory (25 GB for a
4096-document NYT batch, against 36 GB walking tuple by tuple).  Column
slabs go slowest, so the blocks in flight share a few slabs in L2.
``scripts/gather_probe.py`` (H100 80GB HBM3, 700 W) measured 5.5 ms for
the batch against 6.4 for ``torch.sparse.mm`` and 11.1 for the tuple
walk, and 2.1 ms with every row L2-resident: about two fifths of the time
is shared-memory reads and issue, the rest rows that miss L2.  The TPU's densify-then-MXU slab, its occupancy map
and cached head slabs have no counterpart.  fp32 throughout, no TF32.

The ``square`` variant (``gather_tiled<kSquare>``) squares each gathered
value before the product, v·m² — CS-ICP's tail sum of squares.  ``repro``
passes ``means_t * means_t`` to its kernel, a third (D, K) matrix; here no
such matrix exists, and the bits equal sparse_sim over it.  CS-ICP passes 1
on the tail slots (id ≥ t_th): the high-df ids, few distinct rows that
many documents of a tile name, so the tile stages each once.  At t_th 0
its dead id-0 slots at the end of a row are live too, so the row's ids do
not ascend: the plan gives the tile the row's head (its live slots up to
the last id other than 0), and the id-0 slots after it are added after
the tile's chunks, slot by slot, which keeps the plain version's order.
"""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.esicp_gather import SIMS, SQUARE, library, scratch
from repro_torch.kernels.ref import sparse_sim as plain  # noqa: F401


def launch(ids, vals, means_t, dim: int, sims, counts, *,
           square: bool = False, setting: int = 0) -> None:
    """Launch on the current stream at tile ``setting`` (0-7,
    ``gather_setting_launch``; the autotuner picks it, square has 0 and 4
    only); operands are checked by kernels/ops."""
    lib = library()
    b, p = ids.shape
    k = means_t.shape[1]
    mode = SQUARE if square else SIMS
    rc = lib.gather_setting_launch(
        mode, setting, ids.data_ptr(), vals.data_ptr(), means_t.data_ptr(),
        b, p, dim, k, 0.0, 0.0, None, None, None, sims.data_ptr(),
        None if counts is None else counts.data_ptr(),
        scratch(lib, ids, dim, mode, setting).data_ptr(),
        _build.stream_ptr(ids.device))
    _build.check(lib, "gather", rc)
