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


def wedge_intersect_lifting_numpy(keys_d, keys_h, keys_i, e, row_d, row_h,
                                  row_i, ln, L: int):
    """The CUDA kernel's search, step for step, on the host: binary lifting
    from the highest power of two <= ln on the (d, h unsigned) part of the
    key alone, slots past ln reading as a key above all keys; then a walk
    over the row keys that tie the candidate on (d, h) and have a smaller
    id. Rows are sorted on their ``ln`` prefix. Returns ``(pos, ci,
    ties)`` with ``ties`` the number of walk steps taken."""
    B = len(e)
    E = len(keys_d)
    Lr = row_d.shape[-1]
    pos = np.zeros((B, L), np.int32)
    ci = np.zeros((B, L), np.int32)
    ties = 0
    for b in range(B):
        n = int(ln[b])
        nl = min(max(n, 0), Lr)
        dh = [(int(row_d[b, j]), int(row_h[b, j])) for j in range(nl)]
        top = 1 << (nl.bit_length() - 1) if nl else 0
        for k in range(L):
            j = min(max(int(e[b]) + 1 + k, 0), E - 1)
            kdh, kid = (int(keys_d[j]), int(keys_h[j])), int(keys_i[j])
            ci[b, k] = kid
            p, step = 0, top
            while step:
                m = p + step - 1
                if m < nl and dh[m] < kdh:
                    p += step
                step //= 2
            while p < nl and dh[p] == kdh and int(row_i[b, p]) < kid:
                p += 1
                ties += 1
            pos[b, k] = n if (p == nl and n > nl) else p
    return pos, ci, ties


def csr_shaped_inputs(rng, E: int, B: int, Lr: int, L: int):
    """Pull-lane inputs shaped as the engine gives them. The key arrays are
    one shard's CSR slots: vertex rows back to back, each sorted by (d, h
    unsigned, i) with repeated keys, so a candidate window descends at the
    row boundaries. Each pulled row is a sorted draw with repeats from the
    keys, padded past ``ln`` with the owner's sentinels; ``ln`` takes 0 and
    ``Lr``; ``e`` clamps at both ends. Returns numpy arrays ``(keys_d,
    keys_h (uint32), keys_i, e, row_d, row_h (uint32), row_i, ln)``."""
    d = rng.integers(-1, 6, E).astype(np.int32)
    h = rng.integers(0, 2**32, E, dtype=np.uint64).astype(np.uint32)
    grid = rng.random(E) < 0.3                    # hash ties, ≥ 2³¹ too
    h[grid] = rng.integers(0, 4, int(grid.sum())).astype(np.uint32) << np.uint32(30)
    i = rng.integers(0, E, E).astype(np.int32)
    rep = np.flatnonzero(rng.random(E) < 0.15)
    rep = rep[rep > 0]
    d[rep], h[rep], i[rep] = d[rep - 1], h[rep - 1], i[rep - 1]
    vertex = np.sort(rng.integers(0, max(1, E // 9), E))
    order = np.lexsort((i, h, d, vertex))
    kd, kh, ki = d[order], h[order], i[order]
    e = rng.integers(-3, E + 3, B).astype(np.int32)
    e[:4] = (-L // 2, -2, E - 2, E + 5)[:B]
    ln = rng.integers(0, Lr + 1, B).astype(np.int32)
    ln[::5] = 0
    ln[1::5] = Lr
    rd = np.full((B, Lr), 2**30, np.int32)
    rh = np.full((B, Lr), 0xFFFFFFFF, np.uint32)
    ri = np.full((B, Lr), 2**30, np.int32)
    for b in range(B):
        n = int(ln[b])
        sel = rng.integers(0, E, n)
        sel = sel[np.lexsort((ki[sel], kh[sel], kd[sel]))]
        rd[b, :n], rh[b, :n], ri[b, :n] = kd[sel], kh[sel], ki[sel]
    return kd, kh, ki, e, rd, rh, ri, ln
