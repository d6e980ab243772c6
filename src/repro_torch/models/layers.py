"""Shared neural layers: what the port's GNNs need of
``repro.models.layers``, and the module that holds their weights.

:func:`truncated_normal` draws the reference's initial weights;
:class:`ParamTree` holds a parameter tree of the reference's layout as a
module. The reference's ``ShardRules`` / ``NO_RULES`` are sharding
constraints for a JAX mesh; the port's models run on one card and have
no counterpart, so their ``forward`` takes no ``rules`` argument.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


class ParamTree(nn.Module):
    """A parameter tree — nested dicts and lists of tensors, the layout of
    the reference's ``init_params`` — as a module: each tensor a
    parameter, each dict or list a submodule, named after its path in the
    tree (``blocks.0.filt1.w``, ``layers.1.so2.2.wi``), so a state dict
    carries the reference's names. :meth:`tree` gives the tree back, the
    parameters themselves, for a functional ``forward(cfg, params, ...)``
    that a trainer can differentiate."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        self._keys = []
        for k, v in items:
            k = str(k)
            self._keys.append(k)
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, ParamTree(v))

    def tree(self):
        out = [self._parameters[k] if k in self._parameters
               else self._modules[k].tree() for k in self._keys]
        return out if self._is_list else dict(zip(self._keys, out))
