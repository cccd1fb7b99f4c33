"""The fitted-model artifact (counterpart of ``repro.cluster.model``,
without save/load): the mean index, the training labels and ρ_self, the
history, and the algorithm that produced them."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.cluster.classify import classify_docs
from repro_torch.core.meanindex import MeanIndex, StructuralParams


@dataclasses.dataclass
class FittedModel:
    index: MeanIndex
    labels: torch.Tensor | None = None
    rho_self: torch.Tensor | None = None
    history: list = dataclasses.field(default_factory=list)
    converged: bool = True
    n_iter: int = 0
    algo: str = "esicp"
    # (N,) int32 host assignments after each iteration, when the fit was
    # asked to keep them; else None.
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
