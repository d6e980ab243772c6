"""Exact host oracles for fold_count_max and ring_set: Python loops over
the batch."""
from __future__ import annotations

import numpy as np


def fold_count_max_numpy(slots, amounts, rows, capacity: int):
    """slots, amounts [B] int; rows [B, W] uint32 → (count [capacity]
    int32, packed [capacity, W] uint32); out-of-range slots dropped."""
    rows = np.asarray(rows, np.uint32)
    count = np.zeros(capacity, np.int64)
    packed = np.zeros((capacity, rows.shape[-1]), np.uint32)
    for b, s in enumerate(np.asarray(slots).tolist()):
        if 0 <= s < capacity:
            count[s] += int(amounts[b])
            packed[s] = np.maximum(packed[s], rows[b])
    return count.astype(np.int32), packed


def ring_set_numpy(prior, slots, rows, capacity: int):
    """prior [capacity, 3]; slots [B]; rows [B, 3] → [capacity, 3]: the
    batch written in order, so the highest batch index wins a slot;
    out-of-range slots dropped."""
    out = np.array(prior, np.int32, copy=True)
    rows = np.asarray(rows, np.int32)
    for b, s in enumerate(np.asarray(slots).tolist()):
        if 0 <= s < capacity:
            out[s] = rows[b]
    return out
