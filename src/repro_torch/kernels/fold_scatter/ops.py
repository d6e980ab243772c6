"""fold_count_max (fused count scatter-add + packed-row scatter-max) and
ring_set (last-writer-wins scatter-set into a carried table).

Each wrapper launches its CUDA kernel (``csrc/fold_scatter.cu``) for CUDA
tensors and takes its plain PyTorch version for CPU tensors; the device
alone decides. They replace the JAX package's
``kernels/fold_scatter/fold_scatter.py::fold_count_max_pallas`` and
``ring_set_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.hist.ops import hist_add_plain, hist_max_plain

launches = 0            # fold_count_max kernel launches (not the plain path)
ring_set_launches = 0   # ring_set kernel launches (not the plain path)

# tripoll_fold_count_max(slots, amounts, rows, B, W, cap, table, stream)
FOLD_COUNT_MAX_ARGTYPES = ([_cuda.PTR] * 3 + [_cuda.I64, _cuda.I32, _cuda.I32]
                           + [_cuda.PTR] * 2)
# tripoll_ring_set(slots, B, cap, prior, c0, c1, c2, st0, st1, st2, win,
#                  out, stream)
RING_SET_ARGTYPES = ([_cuda.PTR, _cuda.I64, _cuda.I32] + [_cuda.PTR] * 4
                     + [_cuda.I64] * 3 + [_cuda.PTR] * 3)


def fold_count_max_plain(slots, amounts, rows, capacity: int):
    """Plain PyTorch version: ``slots``, ``amounts`` [B] int32; ``rows``
    [B, W] uint32 bits in int32 → fresh ``(count [capacity] int32, packed
    [capacity, W] uint32 bits)``. Slots outside [0, capacity) are dropped;
    the max compares unsigned. It is the two unfused scatters, which is
    what the fused kernel must equal."""
    return (hist_add_plain(slots, amounts, capacity),
            hist_max_plain(slots, rows, capacity))


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
    # one buffer, zeroed by the launcher on the stream: count, then packed
    if B == 0:
        table = torch.zeros(capacity * (W + 1), dtype=torch.int32, device=dev)
        return table[:capacity], table[capacity:].view(capacity, W)
    table = torch.empty(capacity * (W + 1), dtype=torch.int32, device=dev)
    fn = _cuda.function("fold_scatter", "tripoll_fold_count_max",
                        FOLD_COUNT_MAX_ARGTYPES)
    P = _cuda.ptr
    err = fn(P(slots), P(amounts), P(rows), B, W, capacity, P(table),
             _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        launches += 1
    _cuda.raise_on_error("fold_count_max", err)
    return table[:capacity], table[capacity:].view(capacity, W)


def _columns(rows):
    """[B, 3] rows or a tuple of three [B] columns → the three columns."""
    return tuple(rows) if isinstance(rows, (tuple, list)) else rows.unbind(-1)


def ring_set_plain(prior, slots, rows, capacity: int):
    """Plain PyTorch version: ``prior`` [capacity, 3]; ``slots`` [B];
    ``rows`` [B, 3] or three [B] columns; all int32 → a fresh
    [capacity, 3] table. Each slot in [0, capacity) holds the row of the
    highest batch index that targets it; slots no element targets keep
    ``prior``; other slots are dropped."""
    B = slots.shape[0]
    if B == 0 or capacity == 0:
        return prior.clone()
    gidx = torch.arange(B, dtype=torch.int64, device=slots.device)
    ok = (slots >= 0) & (slots < capacity)
    # a dropped element offers -1 (the identity of the max) at a slot of
    # its own, so that no one slot takes every dropped element's update
    s = torch.where(ok, slots.long(), gidx % capacity)
    win = torch.full((capacity,), -1, dtype=torch.int64, device=slots.device)
    win.scatter_reduce_(0, s, torch.where(ok, gidx, -1), "amax")
    w = win.clamp_min(0)
    picked = torch.stack([c[w] for c in _columns(rows)], -1)
    return torch.where((win >= 0)[:, None], picked, prior)


def ring_set(prior, slots, rows, capacity: int):
    """Last-writer-wins scatter-set of ``rows`` at ``slots`` into a copy of
    the carried ``prior`` table: the highest batch index wins a contested
    slot (deterministic, unlike a plain scatter's ties); out-of-range
    slots (Enumerate's invalid lanes are ``capacity``) are dropped.
    Shapes: ``prior`` [capacity, 3]; ``slots`` [B]; ``rows`` [B, 3], or a
    tuple of three [B] columns (any stride), read where they lie; all
    int32, B < 2³¹. Returns [capacity, 3]."""
    if slots.device.type == "cpu":
        return ring_set_plain(prior, slots, rows, capacity)
    if slots.device.type != "cuda":
        raise ValueError(f"ring_set: unsupported device {slots.device}")
    global ring_set_launches
    dev = slots.device
    B = slots.shape[0]
    for name, t, shape in (("prior", prior, (capacity, 3)),
                           ("slots", slots, (B,))):
        _cuda.check(f"ring_set {name}", t, torch.int32, shape, dev)
    if isinstance(rows, (tuple, list)):
        if len(rows) != 3:
            raise ValueError(f"ring_set: {len(rows)} columns, expected 3")
        for c, col in enumerate(rows):
            _cuda.check_strided(f"ring_set column {c}", col, torch.int32,
                                (B,), dev)
    else:
        _cuda.check("ring_set rows", rows, torch.int32, (B, 3), dev)
    if B >= 2**31:
        raise ValueError(f"ring_set: batch of {B} exceeds int32 indices")
    if B == 0 or capacity == 0:
        return prior.clone()
    cols = _columns(rows)
    out = torch.empty_like(prior)
    win = torch.empty(capacity, dtype=torch.int32, device=dev)
    fn = _cuda.function("fold_scatter", "tripoll_ring_set", RING_SET_ARGTYPES)
    P = _cuda.ptr
    err = fn(P(slots), B, capacity, P(prior), *map(P, cols),
             *(c.stride(0) for c in cols), P(win), P(out),
             _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        ring_set_launches += 1
    _cuda.raise_on_error("ring_set", err)
    return out
