"""Shape-only stand-ins of the port's kernels, for tensors on the meta
device.

Each kernel wrapper (``kernels/*/ops.py``) picks its path by its tensors'
device: the CUDA kernel, the plain PyTorch version on the CPU, and on the
meta device the op registered here, ``torch.ops.repro_torch.<kernel>``,
which has only a meta implementation. It returns the kernel's outputs
(shapes and dtypes) and computes nothing, so a dry-run trace
(:mod:`repro_torch.roofline.count`) sees one op a launch, with the
kernel's operands and outputs, where the plain version would have shown
its own temporaries. Nothing here launches or counts a launch.
"""
from __future__ import annotations

import torch

_LIB = torch.library.Library("repro_torch", "DEF")

_SCHEMAS = {
    "wedge_check": "wedge_check(Tensor keys_d, Tensor keys_h, Tensor keys_i, "
                   "Tensor lo, Tensor hi, Tensor qd, Tensor qh, Tensor qi) "
                   "-> Tensor",
    "wedge_intersect": "wedge_intersect(Tensor keys_d, Tensor keys_h, "
                       "Tensor keys_i, Tensor e, Tensor row_d, Tensor row_h, "
                       "Tensor row_i, Tensor ln, int L) -> (Tensor, Tensor)",
    "intersect": "intersect(Tensor row_d, Tensor row_h, Tensor row_i, "
                 "Tensor ln, Tensor qd, Tensor qh, Tensor qi) -> Tensor",
    "hist_add": "hist_add(Tensor slots, Tensor amounts, int capacity) "
                "-> Tensor",
    "hist_max": "hist_max(Tensor slots, Tensor rows, int capacity) -> Tensor",
    "fold_count_max": "fold_count_max(Tensor slots, Tensor amounts, "
                      "Tensor rows, int capacity) -> (Tensor, Tensor)",
    "ring_set": "ring_set(Tensor prior, Tensor slots, Tensor[] rows, "
                "int capacity) -> Tensor",
}


def _wedge_check(keys_d, keys_h, keys_i, lo, hi, qd, qh, qi):
    return torch.empty_like(lo)


def _wedge_intersect(keys_d, keys_h, keys_i, e, row_d, row_h, row_i, ln, L):
    B = row_d.shape[0]
    return (row_d.new_empty((B, L)), row_d.new_empty((B, L)))


def _intersect(row_d, row_h, row_i, ln, qd, qh, qi):
    return torch.empty_like(qi)


def _hist_add(slots, amounts, capacity):
    return slots.new_empty((capacity,))


def _hist_max(slots, rows, capacity):
    return rows.new_empty((capacity, rows.shape[-1]))


def _fold_count_max(slots, amounts, rows, capacity):
    return (slots.new_empty((capacity,)),
            rows.new_empty((capacity, rows.shape[-1])))


def _ring_set(prior, slots, rows, capacity):
    return torch.empty_like(prior)


for _name, _schema in _SCHEMAS.items():
    _LIB.define(_schema)
    _LIB.impl(_name, globals()[f"_{_name}"], "Meta")


def call(name: str, *args):
    """``torch.ops.repro_torch.<name>(*args)``: the kernel's outputs on the
    meta device."""
    return getattr(torch.ops.repro_torch, name)(*args)
