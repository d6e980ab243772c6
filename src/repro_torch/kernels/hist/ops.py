"""hist_add ([cap] int32 scatter-add) and hist_max ([cap, W] uint32 row
scatter-max), each into a fresh zeroed table.

Each wrapper launches its CUDA kernel (``csrc/hist.cu``) for CUDA tensors
and takes its plain PyTorch version for CPU tensors; the device alone
decides (meta tensors: the kernel's output shapes,
:mod:`repro_torch.kernels._meta`). They replace the JAX package's
``kernels/hist/hist.py::hist_add_pallas`` and ``hist_max_pallas``. In the
port, ``hist_add`` folds the dense-histogram surveys and the pair carries
the counting set's ``"scatter"`` backend (:mod:`repro_torch.core.counting_set`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, _meta
from repro_torch.utils import INT32_MIN, u32_key

hist_add_launches = 0   # hist_add kernel launches (not the plain path)
hist_max_launches = 0   # hist_max kernel launches (not the plain path)

# tripoll_hist_add(slots, amounts, B, cap, count, stream)
HIST_ADD_ARGTYPES = [_cuda.PTR] * 2 + [_cuda.I64, _cuda.I32] + [_cuda.PTR] * 2
# tripoll_hist_max(slots, rows, B, W, cap, packed, stream)
HIST_MAX_ARGTYPES = ([_cuda.PTR] * 2 + [_cuda.I64, _cuda.I32, _cuda.I32]
                     + [_cuda.PTR] * 2)


def _spare_slot(slots, capacity: int) -> torch.Tensor:
    """int64 slots with every one outside [0, capacity) sent to the spare
    slot ``capacity``, which the plain versions drop."""
    return torch.where((slots < 0) | (slots >= capacity), capacity,
                       slots).long()


def hist_add_plain(slots, amounts, capacity: int):
    """Plain PyTorch version: ``slots``, ``amounts`` [B] int32 → a fresh
    [capacity] int32 table; slots outside [0, capacity) are dropped."""
    count = torch.zeros(capacity + 1, dtype=torch.int32, device=slots.device)
    count.index_add_(0, _spare_slot(slots, capacity), amounts)
    return count[:capacity]


def hist_max_plain(slots, rows, capacity: int):
    """Plain PyTorch version: ``slots`` [B] int32; ``rows`` [B, W] uint32
    bits in int32 → a fresh [capacity, W] table of uint32 bits (zero is the
    identity); the max compares unsigned (sign-flipped); slots outside
    [0, capacity) are dropped."""
    W = rows.shape[-1]
    s = _spare_slot(slots, capacity)
    packed = torch.full((capacity + 1, W), INT32_MIN, dtype=torch.int32,
                        device=slots.device)
    packed.scatter_reduce_(0, s[:, None].expand(-1, W), u32_key(rows), "amax")
    return u32_key(packed[:capacity])


def hist_add(slots, amounts, capacity: int):
    """Scatter-add ``amounts`` at ``slots`` into a fresh zeroed
    [capacity] table; slots outside [0, capacity) are dropped. Shapes:
    ``slots``, ``amounts`` [B] int32. Returns [capacity] int32."""
    if slots.device.type == "cpu":
        return hist_add_plain(slots, amounts, capacity)
    if slots.device.type == "meta":
        return _meta.call("hist_add", slots, amounts, capacity)
    if slots.device.type != "cuda":
        raise ValueError(f"hist_add: unsupported device {slots.device}")
    global hist_add_launches
    dev = slots.device
    B = slots.shape[0]
    for name, t in (("slots", slots), ("amounts", amounts)):
        _cuda.check(f"hist_add {name}", t, torch.int32, (B,), dev)
    if B == 0 or capacity == 0:
        return torch.zeros(capacity, dtype=torch.int32, device=dev)
    # written whole by the kernel, or zeroed by its launcher on the stream
    count = torch.empty(capacity, dtype=torch.int32, device=dev)
    fn = _cuda.function("hist", "tripoll_hist_add", HIST_ADD_ARGTYPES)
    P = _cuda.ptr
    err = fn(P(slots), P(amounts), B, capacity, P(count),
             _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        hist_add_launches += 1
    _cuda.raise_on_error("hist_add", err)
    return count


def hist_max(slots, rows, capacity: int):
    """Row-wise unsigned scatter-max of ``rows`` at ``slots`` into a fresh
    zeroed [capacity, W] table; slots outside [0, capacity) are dropped.
    Shapes: ``slots`` [B]; ``rows`` [B, W]; int32 (``rows`` holds uint32
    bits). Returns [capacity, W] int32 holding uint32 bits."""
    if slots.device.type == "cpu":
        return hist_max_plain(slots, rows, capacity)
    if slots.device.type == "meta":
        return _meta.call("hist_max", slots, rows, capacity)
    if slots.device.type != "cuda":
        raise ValueError(f"hist_max: unsupported device {slots.device}")
    global hist_max_launches
    dev = slots.device
    B = slots.shape[0]
    W = rows.shape[-1]
    _cuda.check("hist_max slots", slots, torch.int32, (B,), dev)
    _cuda.check("hist_max rows", rows, torch.int32, (B, W), dev)
    if B == 0 or capacity == 0 or W == 0:
        return torch.zeros((capacity, W), dtype=torch.int32, device=dev)
    packed = torch.empty((capacity, W), dtype=torch.int32, device=dev)
    fn = _cuda.function("hist", "tripoll_hist_max", HIST_MAX_ARGTYPES)
    P = _cuda.ptr
    err = fn(P(slots), P(rows), B, W, capacity, P(packed),
             _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        hist_max_launches += 1
    _cuda.raise_on_error("hist_max", err)
    return packed
