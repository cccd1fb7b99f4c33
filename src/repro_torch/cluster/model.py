"""The fitted-model artifact (counterpart of ``repro.cluster.model``): the
mean index, the training labels and ρ_self, the history, and provenance.

``save``/``load`` ride the checkpoint store in ``repro``'s format
(``repro.cluster/fitted-model-v1``), so a model either package saved loads
in the other.  ``repro`` resolves the saved ``backend`` name when it loads
a model, so the port writes ``"auto"`` there and its own provenance under
keys ``repro`` ignores (``runtime``, ``device``).  The same holds for the
autotuner's winner: ``repro``'s loader puts a ``tuned`` dict into its own
cache, and its ``TunedConfig`` refuses any engine but its two, so the
port writes its winner under ``cuda_tuned`` and carries ``tuned`` (a
``repro`` artifact's Pallas or XLA config, or None) as an opaque dict
that never reaches the port's cache.  ``load`` puts ``cuda_tuned`` into
:data:`repro_torch.tune.TUNED_CACHE`, so a later fit of that corpus
regime with ``tune="cached"`` reuses it.  The nested two-level
artifact (:class:`TwoLevelFittedModel`, ``repro.cluster/fitted-two-level-
v1``) loads and saves the same way, and :meth:`FittedModel.load` hands it
back for either format.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.store import (load_extra, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.cluster.classify import (classify_docs,
                                          classify_docs_routed,
                                          transform_docs)
from repro_torch.core.meanindex import (MeanIndex, StructuralParams,
                                        build_mean_index)

MODEL_FORMAT = "repro.cluster/fitted-model-v1"
TWO_LEVEL_FORMAT = "repro.cluster/fitted-two-level-v1"


def seed_tuned_cache(cuda_tuned: dict | None) -> None:
    """Put an artifact's ``cuda_tuned`` winner into the port's autotuner
    cache under its signature (nothing for None or an unsigned config)."""
    if cuda_tuned and cuda_tuned.get("signature"):
        from repro_torch.tune import TUNED_CACHE, TunedConfig

        TUNED_CACHE.put(cuda_tuned["signature"],
                        TunedConfig.from_dict(cuda_tuned))


@dataclasses.dataclass
class FittedModel:
    """index: MeanIndex.  labels / rho_self: (N,) int32 / float32 of the
    training corpus.  history: per-iteration diagnostics.  algo, backend,
    strategy: provenance.  cursor: streaming fits only, (next_epoch,
    next_chunk) of an unconverged fit, else None.  trajectory: (N,) int32
    host assignments after each iteration, when the fit kept them.
    tuned: ``repro``'s autotuner winner, carried as it was loaded.
    cuda_tuned: the port's winner (``repro_torch.tune.TunedConfig``'s
    dict) the fit ran with, else None."""

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
    cuda_tuned: dict | None = None

    FORMAT = MODEL_FORMAT

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
        # keep=None: an artifact writer never prunes other steps sharing
        # the directory.
        return save_checkpoint(directory, self._tree(), step=step, keep=None,
                               extra=self._extra())

    def _extra(self) -> dict:
        dev = self.device
        return {
            "format": self.FORMAT,
            "algo": self.algo,
            "backend": "auto",
            "strategy": self.strategy,
            "k": int(self.k),
            "dim": int(self.dim),
            "n_docs": (0 if self.labels is None
                       else int(self.labels.shape[0])),
            "converged": bool(self.converged),
            "n_iter": int(self.n_iter),
            "history": self.history,
            "cursor": None if self.cursor is None else list(self.cursor),
            "tuned": self.tuned,
            "cuda_tuned": self.cuda_tuned,
            "runtime": "repro_torch",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
        }

    @classmethod
    def load(cls, directory: str, *, step: int | None = None,
             device="cuda") -> FittedModel:
        dev = resolve_device(device)
        extra = load_extra(directory, step=step)
        fmt = extra.get("format") if extra else None
        if fmt == TWO_LEVEL_FORMAT and cls is FittedModel:
            return TwoLevelFittedModel.load(directory, step=step, device=dev)
        if fmt != cls.FORMAT:
            raise ValueError(f"{directory} holds no {cls.FORMAT} artifact "
                             f"(found {fmt!r})")
        tree, _ = restore_checkpoint(directory, {
            name: np.broadcast_to(np.int8(0), s)
            for name, s in cls._shapes(extra).items()}, step=step)
        t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)
        model = cls(**cls._fields(tree, extra, t))
        seed_tuned_cache(model.cuda_tuned)
        return model

    def _tree(self) -> dict:
        labels = (torch.zeros((0,), dtype=torch.int32) if self.labels is None
                  else self.labels)
        rho = (torch.zeros((0,), dtype=torch.float32)
               if self.rho_self is None else self.rho_self)
        p = self.index.params
        return {
            "labels": labels.to(torch.int32),
            "means_t": self.index.means_t,
            "moving": self.index.moving,
            "rho_self": rho.to(torch.float32),
            "t_th": np.asarray(p.t_th, np.int32),
            "v_th": np.asarray(p.v_th, np.float32),
        }

    @staticmethod
    def _shapes(extra: dict) -> dict:
        n, d, k = extra["n_docs"], extra["dim"], extra["k"]
        return {"labels": (n,), "means_t": (d, k), "moving": (k,),
                "rho_self": (n,), "t_th": (), "v_th": ()}

    @staticmethod
    def _fields(tree: dict, extra: dict, t) -> dict:
        params = StructuralParams(int(tree["t_th"]), float(tree["v_th"]))
        return dict(index=build_mean_index(t(tree["means_t"], np.float32),
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
                    tuned=extra.get("tuned"),
                    cuda_tuned=extra.get("cuda_tuned"))


@dataclasses.dataclass
class TwoLevelFittedModel(FittedModel):
    """The nested two-level IVF artifact (``repro``'s
    ``TwoLevelFittedModel``).

    ``index`` holds the fine means of all cells, cell 0's block first, so
    every flat surface (``transform``, flat ``classify_docs``) works on it
    and ``labels`` are global fine ids.  On top:

    coarse_index: MeanIndex over the K_c coarse cell means.
    cell_sizes:   (K_c,) int32 numpy, fine clusters per cell (each >= 1;
                  an empty coarse cell keeps its coarse mean);
                  ``cell_starts`` is their exclusive cumsum.
    n_probe:      the default probe width of ``predict``, ``score`` and
                  serving (n_probe = K_c is the flat classify).
    cell_meta:    per-cell fit provenance ({n_docs, k, n_iter, converged}).
    """

    coarse_index: MeanIndex | None = None
    cell_sizes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    n_probe: int = 1
    cell_meta: list = dataclasses.field(default_factory=list)

    FORMAT = TWO_LEVEL_FORMAT

    @property
    def coarse_k(self) -> int:
        return self.coarse_index.k

    @property
    def cell_starts(self) -> np.ndarray:
        """(K_c,) int32 offset of each cell's block in ``index``."""
        sizes = np.asarray(self.cell_sizes, np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    def _routed_operands(self, device=None):
        """(coarse means_t, fine means_t, starts (K_c,) int32, sizes
        (K_c,) int32, cmax) on ``device`` (default: the index's), cached
        per device.  No sentinel column: the routed kernel masks the slots
        past a cell's size itself, where ``repro`` appends a zero column
        (a third 19.8 GB matrix at the NYT widths)."""
        dev = resolve_device(self.device if device is None else device)
        cache = self.__dict__.setdefault("_routed_cache", {})
        if dev not in cache:
            i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
            cache[dev] = (self.coarse_index.means_t.to(dev),
                          self.index.means_t.to(dev), i32(self.cell_starts),
                          i32(self.cell_sizes), int(np.max(self.cell_sizes)))
        return cache[dev]

    def predict(self, docs, *, batch_size: int = 4096,
                n_probe: int | None = None) -> torch.Tensor:
        """(N,) int32 global fine ids through the coarse-routed classify
        (K_c + Σ probed cell sizes centroids scored per document)."""
        return classify_docs_routed(self, docs, n_probe=n_probe,
                                    batch_size=batch_size)[0]

    def score(self, docs, *, batch_size: int = 4096,
              n_probe: int | None = None) -> float:
        _, sims = classify_docs_routed(self, docs, n_probe=n_probe,
                                       batch_size=batch_size)
        return float(sims.double().sum())

    def _tree(self) -> dict:
        cp = self.coarse_index.params
        return {**super()._tree(),
                "coarse_means_t": self.coarse_index.means_t,
                "coarse_t_th": np.asarray(cp.t_th, np.int32),
                "coarse_v_th": np.asarray(cp.v_th, np.float32),
                "cell_sizes": np.asarray(self.cell_sizes, np.int32)}

    def _extra(self) -> dict:
        return {**super()._extra(), "coarse_k": int(self.coarse_k),
                "n_probe": int(self.n_probe), "cell_meta": self.cell_meta}

    @staticmethod
    def _shapes(extra: dict) -> dict:
        d, k_c = extra["dim"], extra["coarse_k"]
        return {**FittedModel._shapes(extra), "coarse_means_t": (d, k_c),
                "coarse_t_th": (), "coarse_v_th": (), "cell_sizes": (k_c,)}

    @staticmethod
    def _fields(tree: dict, extra: dict, t) -> dict:
        cparams = StructuralParams(int(tree["coarse_t_th"]),
                                   float(tree["coarse_v_th"]))
        return {**FittedModel._fields(tree, extra, t),
                "coarse_index": build_mean_index(
                    t(tree["coarse_means_t"], np.float32), cparams),
                "cell_sizes": np.array(tree["cell_sizes"], np.int32),
                "n_probe": int(extra["n_probe"]),
                "cell_meta": list(extra.get("cell_meta") or [])}


def load_model(directory: str, *, step: int | None = None,
               device="cuda") -> FittedModel:
    """Module-level alias of :meth:`FittedModel.load` (a two-level
    artifact loads as :class:`TwoLevelFittedModel`)."""
    return FittedModel.load(directory, step=step, device=device)
