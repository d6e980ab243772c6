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


def fold_warp_numpy(slots, amounts, rows, capacity: int, *, path: str,
                    blocks: int = 1, warps: int = 32, slices: int = 1):
    """The CUDA fold body (``csrc/fold_common.cuh``), step for step on the
    host: fold_count_max's with both ``amounts`` and ``rows``, hist_add's
    with ``rows`` None (count only), hist_max's with ``amounts`` None (max
    only). Warps take chunks of 32 consecutive elements, chunk c going to
    warp c mod (blocks · warps) of the grid. In a chunk, where every kept
    lane (slot in range) has one amount a, the kept lanes group by slot
    and each group adds a · its size, one update a group, on device
    atomics, and in shared tables where rows are folded too; otherwise
    (and in hist_add's shared tables) each kept lane adds its own amount. Zero amounts never update. A word
    updates the table where it exceeds the word there (``"single"`` and
    ``"blocks"``: the block's tables in shared memory) or where it is
    non-zero (``"direct"``: device atomics). ``"single"`` is one block
    whose tables are the result; ``"blocks"`` cuts the table into
    ``slices`` slices (of ⌈capacity / slices⌉ slots, rounded up to a
    multiple of 32 when more than one), gives each of the ``blocks``
    replicas one block a slice, where a lane is kept by the block of its
    slot's slice, and flushes each block's touched slots into zeroed
    tables, skipping zero counts and words (a count-only fold flushes its
    non-zero counts: it keeps no touched bitmap). Sums wrap as int32. Returns
    ``(count [capacity] int32 or None, packed [capacity, W] uint32 or
    None, stats)``; ``stats`` counts kept lanes, count updates, word
    updates and flushed slots."""
    slots = np.asarray(slots, np.int64)
    do_count, do_max = amounts is not None, rows is not None
    amounts = np.asarray(amounts if do_count else np.zeros(len(slots)), np.int64)
    rows = np.asarray(rows if do_max else np.zeros((len(slots), 0)), np.uint32)
    B, W = rows.shape
    if path != "blocks":
        blocks = slices = 1
    size = -(-capacity // slices)
    if slices > 1:
        size = -(-size // 32) * 32
    tables = {(r, k): (np.zeros(size, np.int64), np.zeros((size, W), np.uint32),
                       np.zeros(size, bool))
              for r in range(blocks) for k in range(slices)}
    stats = dict(lanes=0, adds=0, maxes=0, flushed=0)
    for c in range((B + 31) // 32):
        r = (c % (blocks * warps)) // warps
        for k in range(slices):
            t_count, t_packed, touched = tables[r, k]
            n = min(size, capacity - k * size)
            local = slots[32 * c:32 * c + 32] - k * size
            ks = 32 * c + np.flatnonzero((local >= 0) & (local < n))
            stats["lanes"] += len(ks)
            match = do_max or path == "direct"
            if not do_count:
                pass
            elif match and len(ks) and (amounts[ks] == amounts[ks[0]]).all():
                for s in np.unique(slots[ks]):
                    total = int(amounts[ks[0]]) * int((slots[ks] == s).sum())
                    if amounts[ks[0]] != 0:
                        t_count[s - k * size] += total
                        stats["adds"] += 1
            else:
                for j in ks:
                    if amounts[j] != 0:
                        t_count[slots[j] - k * size] += amounts[j]
                        stats["adds"] += 1
            for j in ks:
                s = slots[j] - k * size
                for w in range(W):
                    if rows[j, w] > (t_packed[s, w] if path != "direct" else 0):
                        t_packed[s, w] = max(t_packed[s, w], rows[j, w])
                        stats["maxes"] += 1
                touched[s] = True
    if path == "blocks":
        count = np.zeros(capacity, np.int64)
        packed = np.zeros((capacity, W), np.uint32)
        for (_, k), (t_count, t_packed, touched) in tables.items():
            # a count-only fold keeps no bitmap: it flushes non-zero counts
            flush = touched if do_max else (t_count & 0xFFFFFFFF) != 0
            for s in np.flatnonzero(flush):
                stats["flushed"] += 1
                if t_count[s] & 0xFFFFFFFF:
                    count[k * size + s] += t_count[s]
                packed[k * size + s] = np.maximum(packed[k * size + s],
                                                  t_packed[s])
    else:
        count, packed, _ = tables[0, 0]
    count = count.astype(np.uint32).view(np.int32) if do_count else None
    return count, packed if do_max else None, stats


# the fold body's launch constants (csrc/fold_common.cuh) and
# fold_count_max's one-block limit (csrc/fold_scatter.cu)
FOLD_WARPS, FOLD_UNROLL, SMEM_BLOCK = 32, 4, 227 * 1024
FOLD_SINGLE_MAX_B = 16384


def fold_count_max_route(B: int, W: int, capacity: int) -> dict:
    """The route ``tripoll_fold_count_max`` takes for a batch of B rows of
    W words into ``capacity`` slots, and the shared memory it asks for a
    block: a count table, a [capacity, W] table and a touched bitmap that
    fit in a block beside the rows' stages (32 warps × 4 chunks × 32 rows ×
    W words, only where they alone fit: W ≤ 14) take one block (B ≤ 16,384)
    or blocks. A table too large for that is cut into ``slices`` equal
    slices of a multiple of 32 slots, each as large as a block holds, rows
    read where they lie (path ``blocks``); device atomics (``direct``, no
    shared memory) only where a slice of 32 slots does not fit."""
    stage = FOLD_WARPS * FOLD_UNROLL * 32 * W * 4
    staged = stage <= SMEM_BLOCK
    stages = stage if staged else 0

    def tables(cap):
        return (cap * (1 + W) + (cap + 31) // 32) * 4

    if stages + tables(capacity) <= SMEM_BLOCK:
        return dict(path="single" if B <= FOLD_SINGLE_MAX_B else "blocks",
                    staged=staged, smem=stages + tables(capacity), slices=1)
    if tables(32) > SMEM_BLOCK:
        return dict(path="direct", staged=False, smem=0, slices=1)
    most = SMEM_BLOCK // 4 * 32 // (32 * (1 + W) + 1)
    most -= most % 32
    n = -(-capacity // most)
    size = -(-capacity // n)
    size += -size % 32
    return dict(path="blocks", staged=False, smem=tables(size),
                slices=-(-capacity // size))


def fold_count_max_warp_numpy(slots, amounts, rows, capacity: int, *,
                              path: str, blocks: int = 1, warps: int = 32,
                              slices: int = 1):
    """fold_count_max's fold (:func:`fold_warp_numpy` with both tables):
    ``(count [capacity] int32, packed [capacity, W] uint32, stats)``."""
    return fold_warp_numpy(slots, amounts, rows, capacity, path=path,
                           blocks=blocks, warps=warps, slices=slices)


def skewed_fold_inputs(rng, case: str, B: int, W: int, capacity: int):
    """Fold operands (fold_count_max's, hist_add's and hist_max's) for
    ``case``: every element on one slot, two slots alternating, a Zipf
    draw over 300 slots (these three with amounts 1, as the counting set
    gives them), every slot dropped (-3..-1 and capacity..capacity+2),
    zero amounts with non-zero rows, rows of the extreme words
    (0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 0) on Zipf slots, or uniform
    slots with some dropped; amounts in [0, 4) where not said. The hist
    callers' classes, amounts 1 on kept lanes and 0 on the lanes sent to
    -1 (a sixth, as ``_hist_fold`` sends invalid lanes): ``"sixteen"``
    (uniform over the first 16 slots, MaxEdgeLabelDist's), ``"repeated_ids"``
    (LocalVertexCount's p, q, r concatenated: p in runs of one id),
    ``"hot_bins"`` (ClosureTime's 64 × 64 bins, both coordinates in a few
    log₂ buckets); ``"wrap"``: three slots, every amount 2³⁰ + 7, so that
    group sums wrap as int32. Returns numpy ``(slots, amounts, rows
    (uint32))``."""
    hot = rng.choice(capacity, min(capacity, 300), replace=False)
    if case in ("sixteen", "repeated_ids", "hot_bins", "wrap"):
        slots = _hist_caller_slots(rng, case, B, capacity)
        amounts = (slots >= 0).astype(np.int64)
        if case == "wrap":
            amounts[:] = 2**30 + 7
        rows = rng.integers(1, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
        return slots.astype(np.int32), amounts.astype(np.int32), rows
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


def _hist_caller_slots(rng, case: str, B: int, capacity: int):
    if case == "sixteen":
        slots = rng.integers(0, min(16, capacity), B)
    elif case == "repeated_ids":
        n = -(-B // 3)
        p = np.repeat(np.sort(rng.integers(0, capacity, n)),
                      rng.geometric(0.2, n))[:n]
        slots = np.concatenate([p, rng.integers(0, capacity, 2 * n)])[:B]
    elif case == "hot_bins":
        buckets = np.array([0, 15, 17, 18, 19, 20])
        b1, b2 = (buckets[rng.zipf(1.5, B) % len(buckets)] for _ in range(2))
        slots = (b1 * 64 + b2) % capacity
    else:                                                # "wrap"
        slots = rng.choice(capacity, 3)[rng.integers(0, 3, B)]
    if case != "wrap":
        slots = np.where(rng.random(B) < 1 / 6, -1, slots)
    return slots
