"""fold_count_max: fused count scatter-add + packed-row scatter-max.

The wrapper launches the CUDA kernel (``csrc/fold_scatter.cu``) for CUDA
tensors and takes the plain PyTorch version for CPU tensors; the device
alone decides. It replaces the JAX package's
``kernels/fold_scatter/fold_scatter.py::fold_count_max_pallas``.
(``ring_set``, the other kernel of that file, is not ported yet.)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.utils import INT32_MIN, u32_key

launches = 0   # kernel launches made by this wrapper (not by the plain path)


def fold_count_max_plain(slots, amounts, rows, capacity: int):
    """Plain PyTorch version: ``slots``, ``amounts`` [B] int32; ``rows``
    [B, W] uint32 bits in int32 → fresh ``(count [capacity] int32, packed
    [capacity, W] uint32 bits)``. Slots outside [0, capacity) are dropped;
    the max compares unsigned (sign-flipped)."""
    W = rows.shape[-1]
    s = torch.where((slots < 0) | (slots >= capacity), capacity, slots).long()
    count = torch.zeros(capacity + 1, dtype=torch.int32, device=slots.device)
    count.index_add_(0, s, amounts)
    packed = torch.full((capacity + 1, W), INT32_MIN, dtype=torch.int32,
                        device=slots.device)
    packed.scatter_reduce_(0, s[:, None].expand(-1, W), u32_key(rows), "amax")
    return count[:capacity], u32_key(packed[:capacity])


def fold_count_max(slots, amounts, rows, capacity: int):
    """Count scatter-add and packed-row scatter-max at ``slots`` into fresh
    zeroed tables; out-of-range slots (masked entries are -1) are dropped.
    Shapes: ``slots``, ``amounts`` [B]; ``rows`` [B, W]; all int32
    (``rows`` holds uint32 bits). Returns ``(count [capacity], packed
    [capacity, W])``."""
    if slots.device.type == "cpu":
        return fold_count_max_plain(slots, amounts, rows, capacity)
    if slots.device.type != "cuda":
        raise ValueError(f"fold_count_max: unsupported device {slots.device}")
    global launches
    dev = slots.device
    B = slots.shape[0]
    W = rows.shape[-1]
    for name, t, shape in (("slots", slots, (B,)), ("amounts", amounts, (B,)),
                           ("rows", rows, (B, W))):
        _cuda.check(f"fold_count_max {name}", t, torch.int32, shape, dev)
    count = torch.zeros(capacity, dtype=torch.int32, device=dev)
    packed = torch.zeros((capacity, W), dtype=torch.int32, device=dev)
    if B == 0:
        return count, packed
    fn = _cuda.library("fold_scatter").tripoll_fold_count_max
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    P = _cuda.ptr
    err = fn(P(slots), P(amounts), P(rows), B, W, capacity, P(count),
             P(packed), _cuda.stream_handle(dev))
    launches += 1
    _cuda.raise_on_error("fold_count_max", err)
    return count, packed
