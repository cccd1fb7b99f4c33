"""The mesh runtime on ``torch.distributed`` (counterpart of
``repro.distributed``; ``repro``'s deprecated ``dist_fit`` is not
ported)."""
from repro_torch.distributed.elastic import StepWatchdog, reshard_state
from repro_torch.distributed.kmeans import (DistKMeansState,
                                            dist_assignment_update,
                                            dist_init_state, mesh_fit)

__all__ = ["DistKMeansState", "dist_init_state", "dist_assignment_update",
           "mesh_fit", "reshard_state", "StepWatchdog"]
