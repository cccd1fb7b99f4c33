"""Elastic re-meshing and straggler detection (counterpart of
``repro.distributed.elastic``).

* Every object-axis array (assign, ρ_self, ρ_prev, ub) is a function of the
  object shard, so a job that loses ranks shrinks its mesh, restores its
  last checkpoint and continues; the centroid state (means_t, moving) is
  what must survive, and it is checkpointed every few iterations.

* :func:`reshard_state` puts a checkpointed state on a mesh of another
  object width.  ``repro`` re-places global arrays on the new mesh; with
  one process a rank, the state crosses through the checkpoint instead:
  the mesh fit on mesh A writes it (``mesh_fit(checkpoint_dir=)``), then
  every rank of mesh B restores its own rows and its own columns (the
  "model" layout is kept, so no centroid moves between column blocks that
  the new mesh would not split the same way).

* :class:`StepWatchdog` flags a step that exceeds a multiple of the
  trailing median step time, so a slow rank sends the job down the
  checkpoint-restart path instead of holding the whole mesh back.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.distributed.kmeans import (MESH_CKPT_FORMAT,
                                            DistKMeansState, ShardGeometry,
                                            _local_index)

# The leaves of a mesh checkpoint (``repro``'s ``mesh_fit`` writes them).
MESH_KEYS = ("assign", "iteration", "means_t", "moving", "rho_prev",
             "rho_self", "t_th", "ub", "v_th")


def reshard_state(directory: str, mesh, *, n_docs: int, k: int,
                  obj_chunk: int = 1024, step: int | None = None):
    """The mesh checkpoint at ``step`` (None -> latest; the port's or
    ``repro``'s) as this rank's shards on ``mesh`` -> (state, params,
    history).  ``history`` is the fit's history up to the checkpoint when
    the port wrote it, else empty.  Each rank reads the leaves whole (an
    npz member is read whole) and keeps its rows [:n_docs] of its object
    shard, re-padded for ``obj_chunk``, and its column block."""
    from repro_torch.checkpoint.store import (load_extra, load_manifest,
                                              restore_checkpoint)
    from repro_torch.core.meanindex import StructuralParams

    man = load_manifest(directory, step=step)
    if man["n_leaves"] != len(MESH_KEYS):
        raise ValueError(f"{directory} holds no mesh checkpoint "
                         f"({man['n_leaves']} leaves, not "
                         f"{len(MESH_KEYS)})")
    shapes = dict(zip(MESH_KEYS, man["shapes"]))
    if shapes["means_t"][1] != k or shapes["assign"][0] < n_docs:
        raise ValueError(f"the checkpoint holds K={shapes['means_t'][1]} "
                         f"and {shapes['assign'][0]} rows, not K={k} and "
                         f">= {n_docs}")
    tree, step = restore_checkpoint(directory, {
        name: np.broadcast_to(np.int8(0), shape)
        for name, shape in shapes.items()}, step=step)
    dev = mesh.device
    geo = ShardGeometry.of(mesh, n_docs, k, obj_chunk)
    r0, r1 = geo.row0, geo.row0 + geo.n_real

    def rows(name, dtype):
        a = np.asarray(tree[name])[:n_docs][r0:r1].astype(dtype)
        out = np.zeros((geo.n_loc,) + a.shape[1:], dtype)
        out[:len(a)] = a
        return torch.from_numpy(out).to(dev)

    cols = slice(geo.k0, geo.k0 + geo.k_loc)
    means_t = torch.from_numpy(np.ascontiguousarray(
        np.asarray(tree["means_t"], np.float32)[:, cols])).to(dev)
    moving = torch.from_numpy(np.asarray(tree["moving"], bool)[cols]).to(dev)
    params = StructuralParams(int(tree["t_th"]), float(tree["v_th"]))
    state = DistKMeansState(
        index=_local_index(means_t, moving, params),
        assign=rows("assign", np.int32), rho_self=rows("rho_self", np.float32),
        rho_prev=rows("rho_prev", np.float32),
        iteration=int(tree["iteration"]), ub=rows("ub", np.float32), geo=geo)
    extra = load_extra(directory, step=step)
    history = (list(extra["history"]) if extra
               and extra.get("format") == MESH_CKPT_FORMAT else [])
    return state, params, history


class StepWatchdog:
    """Flags straggling steps against a trailing-median budget."""

    def __init__(self, factor: float = 3.0, warmup: int = 3):
        self.factor = factor
        self.warmup = warmup
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Returns True if this step breached the straggler budget."""
        if self._t0 is None:
            raise RuntimeError("StepWatchdog.stop() before start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        breach = False
        if len(self.times) >= self.warmup:
            med = sorted(self.times)[len(self.times) // 2]
            breach = dt > self.factor * med
        self.times.append(dt)
        if len(self.times) > 64:
            self.times.pop(0)
        return breach

    @property
    def budget(self) -> float | None:
        if len(self.times) < self.warmup:
            return None
        return self.factor * sorted(self.times)[len(self.times) // 2]
