"""Exact host oracle for intersect: a merge-path walk per row, the paper's
serial merge-path intersection."""
from __future__ import annotations

import numpy as np


def intersect_numpy(row_d, row_h, row_i, ln, qd, qh, qi):
    """Rows and candidates [B, L] (``row_h``, ``qh`` uint32), ``ln`` [B] →
    [B, L] int32 lower-bound positions. Each row's candidates are visited
    in sorted order while one pointer walks the row forward."""
    B, L = np.shape(qd)
    out = np.zeros((B, L), np.int32)
    for b in range(B):
        n = min(max(int(ln[b]), 0), L)
        row = [(int(row_d[b, j]), int(row_h[b, j]), int(row_i[b, j]))
               for j in range(n)]
        keys = [(int(qd[b, k]), int(qh[b, k]), int(qi[b, k])) for k in range(L)]
        j = 0
        for k in sorted(range(L), key=keys.__getitem__):
            while j < n and row[j] < keys[k]:
                j += 1
            out[b, k] = j
    return out
