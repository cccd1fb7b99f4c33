"""The fitted-model artifact (counterpart of ``repro.cluster.model``): the
mean index, the training labels and ρ_self, the history, and provenance.

``save``/``load`` ride the checkpoint store in ``repro``'s format
(``repro.cluster/fitted-model-v1``), so a model either package saved loads
in the other.  ``repro`` resolves the saved ``backend`` name when it loads
a model, so the port writes ``"auto"`` there and its own provenance under
keys ``repro`` ignores (``runtime``, ``device``).  ``tuned`` is carried as
an opaque dict (the port has no autotuner yet).  The nested two-level
artifact comes with the IVF slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.store import (load_extra, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.cluster.classify import classify_docs, transform_docs
from repro_torch.core.meanindex import (MeanIndex, StructuralParams,
                                        build_mean_index)

MODEL_FORMAT = "repro.cluster/fitted-model-v1"
TWO_LEVEL_FORMAT = "repro.cluster/fitted-two-level-v1"


@dataclasses.dataclass
class FittedModel:
    """index: MeanIndex.  labels / rho_self: (N,) int32 / float32 of the
    training corpus.  history: per-iteration diagnostics.  algo, backend,
    strategy: provenance.  cursor: streaming fits only, (next_epoch,
    next_chunk) of an unconverged fit, else None.  trajectory: (N,) int32
    host assignments after each iteration, when the fit kept them."""

    index: MeanIndex
    labels: torch.Tensor | None = None
    rho_self: torch.Tensor | None = None
    history: list = dataclasses.field(default_factory=list)
    converged: bool = True
    n_iter: int = 0
    algo: str = "esicp"
    backend: str = "auto"
    strategy: str = "single_host"
    cursor: tuple | None = None
    tuned: dict | None = None
    trajectory: list | None = None

    @property
    def k(self) -> int:
        return self.index.k

    @property
    def dim(self) -> int:
        return self.index.dim

    @property
    def params(self) -> StructuralParams:
        return self.index.params

    @property
    def device(self) -> torch.device:
        return self.index.means_t.device

    @property
    def objective(self) -> float:
        """J = Σ_i ρ_self(i) (Eq. 47) over the training corpus."""
        return float(self.rho_self.double().sum())

    def predict(self, docs, *, batch_size: int = 4096) -> torch.Tensor:
        """(N,) int32 cluster ids (the shared classify path)."""
        return classify_docs(self.index, docs, batch_size=batch_size)[0]

    def transform(self, docs, *, batch_size: int = 4096) -> torch.Tensor:
        """(N, K) float32 cosine similarities to every mean."""
        return transform_docs(self.index, docs, batch_size=batch_size)

    def score(self, docs, *, batch_size: int = 4096) -> float:
        """Σ_i max_j cos(x_i, μ_j), the objective of the best assignment
        (higher is better)."""
        _, sims = classify_docs(self.index, docs, batch_size=batch_size)
        return float(sims.double().sum())

    def servable(self, **kw):
        """This artifact wrapped for the serving plane:
        ``repro_torch.serve.ServableClusterModel(self, **kw)``."""
        from repro_torch.serve.servable import ServableClusterModel

        return ServableClusterModel(self, **kw)

    # -- persistence -------------------------------------------------------
    def save(self, directory: str, *, step: int = 0) -> str:
        """Atomically persist the artifact; returns the committed path."""
        labels = (torch.zeros((0,), dtype=torch.int32) if self.labels is None
                  else self.labels)
        rho = (torch.zeros((0,), dtype=torch.float32)
               if self.rho_self is None else self.rho_self)
        p = self.index.params
        tree = {
            "labels": labels.to(torch.int32),
            "means_t": self.index.means_t,
            "moving": self.index.moving,
            "rho_self": rho.to(torch.float32),
            "t_th": np.asarray(p.t_th, np.int32),
            "v_th": np.asarray(p.v_th, np.float32),
        }
        dev = self.device
        extra = {
            "format": MODEL_FORMAT,
            "algo": self.algo,
            "backend": "auto",
            "strategy": self.strategy,
            "k": int(self.k),
            "dim": int(self.dim),
            "n_docs": int(labels.shape[0]),
            "converged": bool(self.converged),
            "n_iter": int(self.n_iter),
            "history": self.history,
            "cursor": None if self.cursor is None else list(self.cursor),
            "tuned": self.tuned,
            "runtime": "repro_torch",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
        }
        # keep=None: an artifact writer never prunes other steps sharing
        # the directory.
        return save_checkpoint(directory, tree, step=step, keep=None,
                               extra=extra)

    @classmethod
    def load(cls, directory: str, *, step: int | None = None,
             device="cuda") -> FittedModel:
        dev = resolve_device(device)
        extra = load_extra(directory, step=step)
        fmt = extra.get("format") if extra else None
        if fmt == TWO_LEVEL_FORMAT:
            raise NotImplementedError(
                f"{directory} holds a two-level artifact, which needs "
                "two-level IVF (ROADMAP Queue 1 item 5)")
        if fmt != MODEL_FORMAT:
            raise ValueError(f"{directory} holds no {MODEL_FORMAT} artifact "
                             f"(found {fmt!r})")
        n, d, k = extra["n_docs"], extra["dim"], extra["k"]
        shapes = {"labels": (n,), "means_t": (d, k), "moving": (k,),
                  "rho_self": (n,), "t_th": (), "v_th": ()}
        tree, _ = restore_checkpoint(directory, {
            name: np.broadcast_to(np.int8(0), s)
            for name, s in shapes.items()}, step=step)
        t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)
        params = StructuralParams(int(tree["t_th"]), float(tree["v_th"]))
        return cls(index=build_mean_index(t(tree["means_t"], np.float32),
                                          params,
                                          moving=t(tree["moving"], np.bool_)),
                   labels=t(tree["labels"], np.int32),
                   rho_self=t(tree["rho_self"], np.float32),
                   history=list(extra["history"]),
                   converged=extra["converged"], n_iter=extra["n_iter"],
                   algo=extra["algo"], backend=extra["backend"],
                   strategy=extra["strategy"],
                   cursor=(None if extra.get("cursor") is None
                           else tuple(extra["cursor"])),
                   tuned=extra.get("tuned"))


def load_model(directory: str, *, step: int | None = None,
               device="cuda") -> FittedModel:
    """Module-level alias of :meth:`FittedModel.load`."""
    return FittedModel.load(directory, step=step, device=device)
