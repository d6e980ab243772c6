"""The card's constants, the roofline terms of a traced call and the
mesh's byte accounting (the counterpart of the JAX package's
``repro.roofline``): :data:`HW`, :func:`analyze_counted` (on the counts of
:class:`~repro_torch.roofline.count.OpCounter`),
:func:`mesh_collective_plan` and :func:`reconcile_collectives`; the
dry run's tables in :mod:`repro_torch.roofline.report`."""
from repro_torch.roofline.analysis import (HW, analyze_counted,
                                           mesh_collective_plan,
                                           reconcile_collectives)
from repro_torch.roofline.count import OpCounter

__all__ = ["HW", "OpCounter", "analyze_counted", "mesh_collective_plan",
           "reconcile_collectives"]
