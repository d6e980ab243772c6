"""Shared neural layers: what the port's models need of
``repro.models.layers`` so far.

Only :func:`truncated_normal` is here: SchNet, the first model ported,
needs nothing else. The reference's ``ShardRules`` / ``NO_RULES`` are
sharding constraints for a JAX mesh; the port's models run on one card
and have no counterpart, so their ``forward`` takes no ``rules``
argument.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import threefry


def truncated_normal(key, shape, scale, dtype=torch.float32) -> torch.Tensor:
    """``scale`` × a standard normal truncated to (-2, 2), on the CPU.

    ``key`` is a key of :mod:`repro_torch.models.threefry`: the draw is
    ``repro.models.layers.truncated_normal``'s with the matching
    ``jax.random`` key, within float32 rounding. As in the reference, the
    scale is rounded to float32 before it multiplies the draw."""
    shape = tuple(int(s) for s in shape)
    z = torch.from_numpy(threefry.truncated_normal(key, -2.0, 2.0, shape))
    return (torch.tensor(np.float32(scale)) * z).to(dtype)
