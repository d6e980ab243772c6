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


# row lengths every CSR-shaped draw holds: empty, one key, around one warp,
# the scale-18 cell's longest row (d₊max = 421), and one past 1,024
ROW_LENGTHS = (0, 1, 31, 32, 33, 421, 1100)


def csr_wedge_check_inputs(rng, S: int, B: int, extra_rows: int = 40):
    """Push queries shaped as the engine gives them. Each shard's keys are
    CSR rows back to back, each sorted by (d, h unsigned, i): the rows of
    ``ROW_LENGTHS`` and ``extra_rows`` more of 0-64 keys; a quarter of the
    hashes on the 2³⁰ grid (ties, hashes ≥ 2³¹), and runs of keys that tie
    on (d, h) and differ in id. Query b of a shard searches one row (every
    row length among the first queries): a key of the row, a key of the
    row with its id one off (ties broken by id), a random key, a key below
    every key (d = -1) or above every key (d = 7). Returns numpy arrays
    ``(keys_d, keys_h (uint32), keys_i)`` [S, E] and ``(lo, hi, qd, qh
    (uint32), qi)`` [S, B]."""
    lens = np.array(list(ROW_LENGTHS) + list(rng.integers(0, 65, extra_rows)))
    start = np.concatenate([[0], np.cumsum(lens)])
    E = int(start[-1])
    kd = np.zeros((S, E), np.int32)
    kh = np.zeros((S, E), np.uint32)
    ki = np.zeros((S, E), np.int32)
    for s in range(S):
        d = rng.integers(0, 6, E).astype(np.int32)
        h = rng.integers(0, 2**32, E, dtype=np.uint64).astype(np.uint32)
        grid = rng.random(E) < 0.25
        h[grid] = rng.integers(0, 4, int(grid.sum())).astype(np.uint32) << np.uint32(30)
        i = rng.integers(0, 2**31 - 1, E).astype(np.int32)
        tie = np.flatnonzero(rng.random(E) < 0.2)
        tie = tie[tie > 0]
        d[tie], h[tie] = d[tie - 1], h[tie - 1]
        for r in range(len(lens)):
            a, b = start[r], start[r + 1]
            o = np.lexsort((i[a:b], h[a:b], d[a:b]))
            kd[s, a:b], kh[s, a:b], ki[s, a:b] = d[a:b][o], h[a:b][o], i[a:b][o]
    row = rng.integers(0, len(lens), (S, B))
    n0 = min(B, len(ROW_LENGTHS) * 5)   # five kinds of query on each length
    row[:, :n0] = np.repeat(np.arange(len(ROW_LENGTHS)), 5)[None, :n0]
    lo, hi = start[row].astype(np.int32), start[row + 1].astype(np.int32)
    kind = rng.integers(0, 5, (S, B))
    kind[:, :n0] = np.tile(np.arange(5), len(ROW_LENGTHS))[None, :n0]
    pick = lo + (rng.random((S, B)) * np.maximum(hi - lo, 1)).astype(np.int32)
    pick = np.minimum(pick, E - 1)
    take = lambda k: np.take_along_axis(k, pick, 1)
    qd, qh, qi = take(kd).copy(), take(kh).copy(), take(ki).copy()
    empty = hi <= lo
    kind[empty & (kind < 2)] = 2               # no key of an empty row
    qi[kind == 1] += np.where(rng.random(int((kind == 1).sum())) < 0.5, 1, -1).astype(np.int32)
    rnd = kind == 2
    qd[rnd] = rng.integers(-1, 7, int(rnd.sum()))
    qh[rnd] = rng.integers(0, 2**32, int(rnd.sum()), dtype=np.uint64).astype(np.uint32)
    qi[rnd] = rng.integers(0, 2**31 - 1, int(rnd.sum()))
    qd[kind == 3], qd[kind == 4] = -1, 7
    return kd, kh, ki, lo, hi, qd, qh, qi


def lifting_lower_bound_numpy(keys_d, keys_h, keys_i, lo, hi, qd, qh, qi):
    """The CUDA kernel's search, step for step on the host, on one shard
    (1-D keys, ``keys_h``/``qh`` uint32): binary lifting on (d, h) alone
    from the highest power of two <= hi - lo, each step probing p + step -
    1 where it lies below hi; then a walk over the keys that tie the query
    on (d, h) and have a smaller id. An empty slice gives lo. Returns
    ``(pos [B] int32, walked)``: the walk steps taken over all queries."""
    out = np.zeros(len(qd), np.int32)
    walked = 0
    for b in range(len(qd)):
        l, h = int(lo[b]), int(hi[b])
        t = (int(qd[b]), int(qh[b]))
        p = l
        if l < h:
            step = 1 << ((h - l).bit_length() - 1)
            while step:
                m = p + step - 1
                if m < h and (int(keys_d[m]), int(keys_h[m])) < t:
                    p += step
                step //= 2
            while (p < h and (int(keys_d[p]), int(keys_h[p])) == t
                   and int(keys_i[p]) < int(qi[b])):
                p += 1
                walked += 1
        out[b] = p
    return out, walked


# the longest stable-key hub row of the scale-18 cell (d₊max under the
# (0, hash, id) key)
HUB_ROW_MAX = 25374


def hub_wedge_check_inputs(rng, n_rows: int, B: int, max_len: int = HUB_ROW_MAX):
    """The hub lane's search: one key row [1, n_rows · Lh], the hub table
    flattened, each of its rows a stable-key Adj₊ row (d = 0 everywhere,
    distinct ids sorted by (hash unsigned, id), padded to Lh with the
    shard layer's sentinels). Row lengths run from 1 to ``max_len`` (both
    among them). Query b searches row ``hid`` in [hid · Lh, hid · Lh +
    len): a key of the row, a random (0, h, id), or a key below (0, 0,
    -1) or above (0, 2³² - 1, 2³¹ - 1) every key. Returns numpy arrays
    ``(keys_d, keys_h (uint32), keys_i)`` [1, n_rows · Lh] and ``(lo, hi,
    qd, qh (uint32), qi)`` [1, B]."""
    lens = rng.integers(1, max_len + 1, n_rows)
    lens[0], lens[-1] = 1, max_len
    Lh = int(lens.max())
    kd = np.full((n_rows, Lh), 2**30, np.int32)
    kh = np.zeros((n_rows, Lh), np.uint32)
    ki = np.full((n_rows, Lh), 2**31 - 1, np.int32)
    for r, n in enumerate(lens):
        i = rng.choice(2**31 - 2, n, replace=False).astype(np.int32)
        h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        o = np.lexsort((i, h))
        kd[r, :n], kh[r, :n], ki[r, :n] = 0, h[o], i[o]
    hid = rng.integers(0, n_rows, B)
    lo = (hid * Lh).astype(np.int32)
    hi = (lo + lens[hid]).astype(np.int32)
    pick = hid * Lh + (rng.random(B) * lens[hid]).astype(np.int64)
    qd = np.zeros(B, np.int32)
    qh, qi = kh.reshape(-1)[pick].copy(), ki.reshape(-1)[pick].copy()
    kind = rng.integers(0, 4, B)
    rnd = kind == 1
    qh[rnd] = rng.integers(0, 2**32, int(rnd.sum()), dtype=np.uint64).astype(np.uint32)
    qi[rnd] = rng.integers(0, 2**31 - 1, int(rnd.sum()))
    qh[kind == 2], qi[kind == 2] = 0, -1
    qh[kind == 3], qi[kind == 3] = 0xFFFFFFFF, 2**31 - 1
    return (kd.reshape(1, -1), kh.reshape(1, -1), ki.reshape(1, -1),
            lo[None], hi[None], qd[None], qh[None], qi[None])
