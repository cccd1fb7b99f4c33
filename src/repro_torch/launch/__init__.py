"""Launching the port (counterpart of ``repro.launch``): process meshes
and local worlds of ranks (:mod:`repro_torch.launch.mesh`), the LM
serving and training launchers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and the input shape grid
(:mod:`repro_torch.launch.shapes`).  ``repro``'s other LM launchers
(``sharding``, ``steps``, ``dryrun``) are ROADMAP Queue 1 item 3."""
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     make_test_mesh, run_local_world)

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_test_mesh",
           "run_local_world"]
