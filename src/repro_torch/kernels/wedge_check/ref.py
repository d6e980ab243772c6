"""Exact host oracle for wedge_check: per-element Python bisect."""
from __future__ import annotations

import numpy as np


def lower_bound_numpy(keys_d, keys_h, keys_i, lo, hi, qd, qh, qi):
    """1-D keys [E] (``keys_h``/``qh`` uint32) and queries [B] → [B] int32."""
    out = np.zeros(len(qd), np.int32)
    for b in range(len(qd)):
        lo_b, hi_b = int(lo[b]), int(hi[b])
        key = (int(qd[b]), int(qh[b]), int(qi[b]))
        while lo_b < hi_b:
            m = (lo_b + hi_b) // 2
            km = (int(keys_d[m]), int(keys_h[m]), int(keys_i[m]))
            if km < key:
                lo_b = m + 1
            else:
                hi_b = m
        out[b] = lo_b
    return out
