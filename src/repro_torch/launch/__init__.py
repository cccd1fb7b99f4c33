"""Launching the port (counterpart of ``repro.launch``): process meshes
and local worlds of ranks (:mod:`repro_torch.launch.mesh`).  ``repro``'s
LM launchers (``sharding``, ``train``, ``serve``, ``steps``, ``shapes``,
``dryrun``) are ROADMAP Queue 1 item 3."""
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     make_test_mesh, run_local_world)

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_test_mesh",
           "run_local_world"]
