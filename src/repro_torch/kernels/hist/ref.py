"""Exact host oracles for hist_add and hist_max: Python loops over the
batch."""
from __future__ import annotations

import numpy as np


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
