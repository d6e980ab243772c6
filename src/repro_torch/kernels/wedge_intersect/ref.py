"""Exact host oracle for wedge_intersect: explicit gather + bisect."""
from __future__ import annotations

import numpy as np


def wedge_intersect_numpy(keys_d, keys_h, keys_i, e, row_d, row_h, row_i,
                          ln, L: int):
    """1-D keys [E] (``keys_h`` uint32); rows [B, Lr] (``row_h`` uint32) →
    ``(pos, ci)`` [B, L]."""
    B = len(e)
    e_cap = len(keys_d)
    pos = np.zeros((B, L), np.int32)
    ci = np.zeros((B, L), np.int32)
    for b in range(B):
        n = int(ln[b])
        row = [(int(row_d[b, j]), int(row_h[b, j]), int(row_i[b, j]))
               for j in range(n)]
        for kk in range(L):
            j = min(max(int(e[b]) + 1 + kk, 0), e_cap - 1)
            key = (int(keys_d[j]), int(keys_h[j]), int(keys_i[j]))
            ci[b, kk] = keys_i[j]
            lo, hi = 0, n
            while lo < hi:
                m = (lo + hi) // 2
                if row[m] < key:
                    lo = m + 1
                else:
                    hi = m
            pos[b, kk] = lo
    return pos, ci
