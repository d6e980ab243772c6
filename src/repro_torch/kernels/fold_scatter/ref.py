"""Exact host oracle for fold_count_max: a Python loop over the batch."""
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
