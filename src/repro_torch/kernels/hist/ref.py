"""Exact host oracles for hist_add and hist_max (Python loops over the
batch), and models of their CUDA kernels' folds."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.fold_scatter.ref import fold_warp_numpy


def hist_add_numpy(slots, amounts, capacity: int):
    """slots, amounts [B] int → [capacity] int32 (int32 wrap-around, as
    the table's adds); out-of-range slots dropped."""
    count = np.zeros(capacity, np.int64)
    for s, a in zip(np.asarray(slots).tolist(), np.asarray(amounts).tolist()):
        if 0 <= s < capacity:
            count[s] += a
    return count.astype(np.uint32).view(np.int32)


def hist_max_numpy(slots, rows, capacity: int):
    """slots [B] int; rows [B, W] uint32 → [capacity, W] uint32 (zero is
    the identity); out-of-range slots dropped."""
    rows = np.asarray(rows, np.uint32)
    packed = np.zeros((capacity, rows.shape[-1]), np.uint32)
    for b, s in enumerate(np.asarray(slots).tolist()):
        if 0 <= s < capacity:
            packed[s] = np.maximum(packed[s], rows[b])
    return packed


def hist_add_warp_numpy(slots, amounts, capacity: int, **path):
    """The hist_add kernel's fold on the host: the shared fold body
    counting only, match-aggregated on device atomics alone
    (:func:`fold_warp_numpy`; ``path``, ``blocks``, ``warps`` and
    ``slices`` as there). Returns ``(count [capacity] int32, stats)``."""
    count, _, stats = fold_warp_numpy(slots, amounts, None, capacity, **path)
    return count, stats


def hist_max_warp_numpy(slots, rows, capacity: int, **path):
    """The hist_max kernel's fold on the host: the shared fold body maxing
    only (the launcher takes its one-block path). Returns ``(packed
    [capacity, W] uint32, stats)``."""
    _, packed, stats = fold_warp_numpy(slots, None, rows, capacity, **path)
    return packed, stats
