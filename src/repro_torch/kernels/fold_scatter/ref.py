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


def fold_count_max_warp_numpy(slots, amounts, rows, capacity: int, *,
                              path: str, blocks: int = 1, warps: int = 32):
    """The CUDA kernel's fold, step for step on the host. Warps take
    chunks of 32 consecutive elements, chunk c going to warp c mod
    (blocks · warps) of the grid. In a chunk, where every kept lane (slot
    in range) has one amount a, the kept lanes group by slot and each
    group adds a · its size, one update a group; otherwise each kept lane
    adds its own amount. Zero amounts never update. A word updates the
    table where it exceeds the word there (``"single"`` and ``"blocks"``:
    the block's tables in shared memory) or where it is non-zero
    (``"direct"``: device atomics). ``"single"`` is one block whose
    tables are the result; ``"blocks"`` flushes each block's touched
    slots into zeroed tables, skipping zero words. Sums wrap as int32.
    Returns ``(count [capacity] int32, packed [capacity, W] uint32,
    stats)``; ``stats`` counts kept lanes, count updates, word updates and
    flushed slots."""
    slots = np.asarray(slots, np.int64)
    amounts = np.asarray(amounts, np.int64)
    rows = np.asarray(rows, np.uint32)
    B, W = rows.shape
    n_tables = blocks if path == "blocks" else 1
    tables = [(np.zeros(capacity, np.int64), np.zeros((capacity, W), np.uint32),
               np.zeros(capacity, bool)) for _ in range(n_tables)]
    stats = dict(lanes=0, adds=0, maxes=0, flushed=0)
    for c in range((B + 31) // 32):
        t_count, t_packed, touched = tables[(c % (n_tables * warps)) // warps]
        ks = 32 * c + np.flatnonzero((slots[32 * c:32 * c + 32] >= 0)
                                     & (slots[32 * c:32 * c + 32] < capacity))
        stats["lanes"] += len(ks)
        if len(ks) and (amounts[ks] == amounts[ks[0]]).all():
            for s in np.unique(slots[ks]):
                total = int(amounts[ks[0]]) * int((slots[ks] == s).sum())
                if amounts[ks[0]] != 0:
                    t_count[s] += total
                    stats["adds"] += 1
        else:
            for k in ks:
                if amounts[k] != 0:
                    t_count[slots[k]] += amounts[k]
                    stats["adds"] += 1
        for k in ks:
            s = slots[k]
            for w in range(W):
                if rows[k, w] > (t_packed[s, w] if path != "direct" else 0):
                    t_packed[s, w] = max(t_packed[s, w], rows[k, w])
                    stats["maxes"] += 1
            touched[s] = True
    if path != "blocks":
        count, packed, _ = tables[0]
        return count.astype(np.int32), packed, stats
    count = np.zeros(capacity, np.int64)
    packed = np.zeros((capacity, W), np.uint32)
    for t_count, t_packed, touched in tables:
        for s in np.flatnonzero(touched):
            stats["flushed"] += 1
            if t_count[s] & 0xFFFFFFFF:
                count[s] += t_count[s]
            packed[s] = np.maximum(packed[s], t_packed[s])
    return count.astype(np.int32), packed, stats


def skewed_fold_inputs(rng, case: str, B: int, W: int, capacity: int):
    """fold_count_max operands for ``case``: every element on
    one slot, two slots alternating, a Zipf draw over 300 slots (these
    three with amounts 1, as the counting set gives them), every slot
    dropped (-3..-1 and capacity..capacity+2), zero amounts with non-zero
    rows, rows of the extreme words (0xFFFFFFFF, 0x80000000, 0x7FFFFFFF,
    1, 0) on Zipf slots, or uniform slots with some dropped; amounts in
    [0, 4) where not said. Returns numpy ``(slots, amounts, rows
    (uint32))``."""
    hot = rng.choice(capacity, min(capacity, 300), replace=False)
    if case == "one_slot":
        slots = np.full(B, hot[0])
    elif case == "alternating":
        slots = np.where(np.arange(B) % 2 == 0, hot[0], hot[-1])
    elif case in ("zipf", "zero_amounts", "extreme_words"):
        slots = hot[(rng.zipf(1.3, B) - 1) % len(hot)]
    elif case == "dropped":
        slots = np.where(rng.random(B) < 0.5, -1 - rng.integers(0, 3, B),
                         capacity + rng.integers(0, 3, B))
    else:
        slots = rng.integers(-3, capacity + 3, B)
    amounts = rng.integers(0, 4, B)
    if case in ("one_slot", "alternating", "zipf"):
        amounts[:] = 1
    elif case == "zero_amounts":
        amounts[:] = 0
    rows = rng.integers(1, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    if case == "extreme_words":
        rows = rng.choice(np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 0],
                                   np.uint32), (B, W))
    return slots.astype(np.int32), amounts.astype(np.int32), rows
