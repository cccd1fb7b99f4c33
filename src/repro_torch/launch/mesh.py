"""Process meshes (counterpart of ``repro.launch.mesh``).

``repro`` lays a JAX mesh over devices; here a rank is one process with
one device, and the mesh lays named axes over the ranks of the default
process group, row-major (rank = coordinates raveled over ``shape``, the
last axis fastest).  The axes are ``repro``'s: ``"model"`` splits the
centroids, every other axis (``"pod"``, ``"data"``) splits the objects,
pod-major.  Rank r computes on ``cuda:(local_rank % device_count)``
(``LOCAL_RANK`` from the launcher, else the global rank), or on the CPU
when the caller asks for it.

The process group and its backend are the caller's: NCCL on a multi-GPU
host; gloo on the CPU and for ranks that share one card (NCCL refuses two
ranks on one device).  A :class:`Mesh` holds one group per reduction:
the model group (the ranks of one object shard) and the object group (the
ranks of one centroid shard, over all non-model axes together).  The
groups are hand-built with ``new_group``: every rank creates every
subgroup, all model groups first, then all object groups, each in
ascending order, so no two ranks ever wait on different creations.
``DeviceMesh`` would build the per-axis groups itself, but the object
group of ("pod", "data") needs its private ``_flatten``, whose signature
has moved between releases.  A group of one rank is no group at all: its
collectives are skipped (XLA drops them too), so a world of one runs no
collective.

gloo's support for CUDA tensors differs by collective and by release
(``gather`` and ``all_gather`` on CUDA tensors are not in every build), so
every gloo collective of a CUDA tensor goes through a pinned host copy.
Nothing here catches a failed collective or switches backend or device.

:func:`run_local_world` spawns a world of ranks on this host, each with
the default group initialised, for the tests and ``chip_smoke.py``;
``torchrun --nproc-per-node N`` does the same for a user's script.
"""
from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Mesh:
    """Named axes over the ranks of the default process group.

    shape:        {axis: size}, a mapping (``ClusterConfig.validate`` reads
                  ``dict(mesh.shape)``, as ``repro`` reads a JAX mesh's).
    axis_names:   the axes in order.
    object_axes:  every axis but ``"model"``.
    rank, coords: this process's global rank and its coordinates.
    device:       this rank's device.

    ``model_size`` / ``model_index`` and ``object_size`` /
    ``object_index`` place the rank in the centroid and object splits.
    """

    def __init__(self, shape, axes, *, device="cuda"):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             "up, one distinct name an axis")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must have size >= 1, got {shape}")
        world = math.prod(shape)
        if dist.is_initialized():
            rank, size = dist.get_rank(), dist.get_world_size()
        elif world == 1:
            rank, size = 0, 1
        else:
            raise RuntimeError(f"a {shape} mesh needs an initialised default "
                               f"process group of {world} ranks")
        if size != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} has {world} "
                             f"ranks; the default group has {size}")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.object_axes = tuple(a for a in axes if a != "model")
        self.rank = rank
        self.coords = dict(zip(axes, _unravel(rank, shape)))
        self.model_size = self.shape.get("model", 1)
        self.model_index = self.coords.get("model", 0)
        self.object_size = world // self.model_size
        self.object_index = _ravel([self.coords[a] for a in self.object_axes],
                                   [self.shape[a] for a in self.object_axes])
        self.device = _rank_device(device, rank)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        # Every rank creates every group, in one order.
        self._groups, self._members = {}, {}
        for over, n_groups, members_of in (
                ("model", self.object_size, self._model_members),
                ("object", self.model_size, self._object_members)):
            mine = (self.object_index if over == "model"
                    else self.model_index)
            self._members[over] = members_of(mine)
            self._groups[over] = None
            if len(self._members[over]) == 1:
                continue
            for g in range(n_groups):
                group = dist.new_group(members_of(g))
                if g == mine:
                    self._groups[over] = group

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")

    def _rank_of(self, object_index: int, model_index: int) -> int:
        obj = _unravel(object_index, [self.shape[a] for a in self.object_axes])
        coords = dict(zip(self.object_axes, obj))
        coords["model"] = model_index
        return _ravel([coords.get(a, 0) for a in self.axis_names],
                      list(self.shape.values()))

    def _model_members(self, object_index: int) -> list[int]:
        return [self._rank_of(object_index, m) for m in range(self.model_size)]

    def _object_members(self, model_index: int) -> list[int]:
        return [self._rank_of(o, model_index) for o in range(self.object_size)]

    # -- collectives ---------------------------------------------------------
    def leader(self, over: str) -> int:
        """Global rank of the first member of this rank's ``over`` group
        ('model' or 'object')."""
        return self._members[over][0]

    def is_leader(self, over: str) -> bool:
        return self.rank == self.leader(over)

    def _staged(self, t: torch.Tensor, over: str) -> bool:
        return t.is_cuda and dist.get_backend(self._groups[over]) == "gloo"

    def all_reduce(self, t: torch.Tensor, op: str = "sum", *,
                   over: str) -> torch.Tensor:
        """``t`` reduced over the ``over`` group, in place; returns ``t``."""
        group = self._groups[over]
        if group is None:
            return t
        if self._staged(t, over):
            h = _pinned(t)
            dist.all_reduce(h, op=_OPS[op], group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=_OPS[op], group=group)
        return t

    def broadcast(self, t: torch.Tensor, *, over: str) -> torch.Tensor:
        """The group leader's ``t`` on every member, in place."""
        group = self._groups[over]
        if group is None:
            return t
        src = self.leader(over)
        if self._staged(t, over):
            h = _pinned(t)
            dist.broadcast(h, src=src, group=group)
            t.copy_(h)
        else:
            dist.broadcast(t, src=src, group=group)
        return t

    def all_gather(self, t: torch.Tensor, *, over: str) -> list:
        """Every member's ``t`` (one shape on all), in group order."""
        if self._groups[over] is None:
            return [t]
        src = _pinned(t) if self._staged(t, over) else t
        out = [torch.empty_like(src) for _ in self._members[over]]
        dist.all_gather(out, src, group=self._groups[over])
        return [o.to(t.device) for o in out]

    def gather(self, t: torch.Tensor, *, over: str) -> list | None:
        """Every member's ``t`` (one shape on all) on the group leader, in
        group order; None on the other members."""
        if self._groups[over] is None:
            return [t]
        src = _pinned(t) if self._staged(t, over) else t
        lead = self.is_leader(over)
        out = [torch.empty_like(src) for _ in self._members[over]] \
            if lead else None
        dist.gather(src, out, dst=self.leader(over),
                    group=self._groups[over])
        return [o.to(t.device) for o in out] if lead else None


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _unravel(i: int, shape) -> list[int]:
    out = []
    for s in reversed(list(shape)):
        out.append(i % s)
        i //= s
    return out[::-1]


def _ravel(coords, shape) -> int:
    i = 0
    for c, s in zip(coords, shape):
        i = i * s + c
    return i


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(shape, axes, *, device="cuda") -> Mesh:
    """A mesh over the default process group (a world of one needs none)."""
    return Mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """``repro``'s pod meshes: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model").  These are TPU pod sizes; they need a world
    of 256 or 512 ranks, which no host of this port has."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device="cuda") -> Mesh:
    """A small mesh over however many ranks the default group has."""
    return make_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# A world of local ranks.
# ---------------------------------------------------------------------------

def _world_entry(rank, world_size, backend, init_file, threads, job_file,
                 results):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        with open(job_file, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world_size, rank=rank)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_local_world(fn, world_size: int, *, args=(), backend: str = "gloo",
                    timeout: float = 120.0, threads: int = 1,
                    workdir: str | None = None) -> list:
    """``fn(*args)`` on ``world_size`` spawned ranks of this host -> the
    ranks' return values, rank order.

    Each rank starts by ``spawn`` with ``LOCAL_RANK`` set, ``threads``
    torch threads and the default group initialised (``backend``, a
    ``file://`` rendezvous in a fresh directory under ``workdir``, default
    the temporary directory).  ``fn`` and ``args`` must pickle, and so
    must the results.  A rank that raises fails the world with its
    traceback; a world that has not ended after ``timeout`` seconds is
    terminated and raises TimeoutError.  Every rank is joined or killed
    before this returns.
    """
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mesh_world_",
                                     dir=workdir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        # The job goes through a file: a spawned process reads its
        # arguments only once its interpreter is up, and arguments
        # larger than the pipe's buffer would hold up each start.
        job_file = os.path.join(tmp, "job.pickle")
        with open(job_file, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_world_entry, daemon=True,
                             args=(r, world_size, backend, init_file, threads,
                                   job_file, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        ended = False
        try:
            while len(got) + len(errors) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    if errors:          # the others' reports, waited for
                        break
                    raise TimeoutError(f"a world of {world_size} ranks ran "
                                       f"past its {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and results.empty() and not errors:
                        raise RuntimeError(
                            f"rank {procs.index(dead[0])} died with exit "
                            f"code {dead[0].exitcode}") from None
                    continue
                if ok:
                    got[rank] = value
                else:
                    # A failed rank often fails the others' collectives:
                    # collect their reports a few seconds more, so the
                    # first cause is among them.
                    errors.append(f"rank {rank}:\n{value}")
                    deadline = min(deadline, time.monotonic() + 5.0)
            ended = not errors
        finally:
            for p in procs:
                p.join(timeout=10 if ended else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(sorted(errors)))
    return [got[r] for r in range(world_size)]
