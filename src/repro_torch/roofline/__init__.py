"""The card's constants and the mesh's byte accounting (the counterpart of
the JAX package's ``repro.roofline``): :data:`HW`,
:func:`mesh_collective_plan` and :func:`reconcile_collectives`."""
from repro_torch.roofline.analysis import (HW, mesh_collective_plan,
                                           reconcile_collectives)

__all__ = ["HW", "mesh_collective_plan", "reconcile_collectives"]
