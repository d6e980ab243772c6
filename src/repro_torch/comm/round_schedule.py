"""Padding-minimizing round scheduler for the mesh transport.

The ragged mesh exchange decomposes one dest-major exchange into physical
*rounds*. A round is a partial permutation of ``(src, dest)`` pairs — no
repeated source and no repeated destination — and its padded operand is
``max_parts(length)`` slots: the round's *padded* slot count. Chunks may be
*split* across rounds at static lane offsets (the recv compaction places
each slice at its exact ``in_off + lane_lo`` address, so splitting is
invisible downstream). That turns round construction into a scheduling
problem:

    minimize   Σ_rounds max_{(s,d) ∈ round} part_length(s, d)
    subject to every off-diagonal cap covered exactly once,
               each round a partial permutation.

The optimum is the Birkhoff–von-Neumann bound

    T = max(max_s Σ_d caps[s, d],  max_d Σ_s caps[s, d])    (off-diagonal)

— no schedule can beat it (the busiest sender must ship its row sum, one
round contributes at most ``slots`` of it; same for the busiest receiver's
column sum) and the BvN decomposition achieves it exactly: pad the cap
matrix with *slack* until every row and column sums to ``T``, repeatedly
extract a perfect matching from the support (one exists at every step, by
Birkhoff/Hall), and ship ``min matched value`` slots per round. Slack
entries in a matching simply mean that rank idles for the round.

Three candidate schedules are built and the best by
``(total padded slots, round count)`` is kept:

``rotation``  the diagonal schedule: round ``k`` ships ``(s, (s+k) mod S)``
              — the baseline, and the guarantee that scheduling never
              regresses;
``greedy``    first-fit-decreasing bin packing of whole chunks into
              partial-permutation rounds — no splits, so fewer rounds
              when raggedness is mild;
``bvn``       the matching decomposition above — optimal total, possibly
              more rounds (chunks split across matchings).

The self diagonal never crosses the wire (it is a local copy in
:class:`~repro_torch.comm.mesh_exchange.MeshExchange`), so it is carried
separately as ``local_parts``. Everything here is host-side numpy / pure
python and **deterministic** — the planner and the transport both call
:func:`best_schedule` on the same cap matrix and get the identical object.
This module is the JAX package's scheduler, copied line for line, so the
two packages build the same rounds part by part.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SCHEDULE_METHODS = ("rotation", "greedy", "bvn")


@dataclass(frozen=True)
class RoundPart:
    """One contiguous slice of the (src, dest) chunk shipped in one round.

    ``lane_lo`` is the static offset within the chunk: the slice covers
    block lanes ``[lane_lo, lane_lo + length)`` of pair (src, dest), i.e.
    send slots ``block_off[src, dest] + lane_lo + [0, length)`` and recv
    slots ``in_off[dest, src] + lane_lo + [0, length)``."""

    src: int
    dest: int
    lane_lo: int
    length: int


@dataclass(frozen=True)
class Round:
    """One physical round: a partial permutation of parts.

    ``slots`` is the round's padded operand length — what each source of
    the round ships — and always equals ``max(part.length)``."""

    parts: tuple[RoundPart, ...]
    slots: int


@dataclass(frozen=True)
class RoundSchedule:
    """Static physical round structure for one ragged mesh exchange lane."""

    S: int
    method: str                       # winning candidate ("rotation"/…)
    wire_rounds: tuple[Round, ...]    # off-diagonal traffic, one round each
    local_parts: tuple[RoundPart, ...]  # self diagonal: local copy, no wire

    @property
    def n_rounds(self) -> int:
        return len(self.wire_rounds)

    @property
    def wire_slots(self) -> int:
        """Σ_rounds padded slots — the per-device wire cost of one
        superstep of this lane when every rank holds each round's padded
        operand (the quantity the scheduler minimizes)."""
        return sum(r.slots for r in self.wire_rounds)

    def padding_slots(self) -> int:
        """Σ_rounds (S·slots − Σ part lengths): total wire slots carrying
        padding across all devices, per superstep."""
        return sum(self.S * r.slots - sum(p.length for p in r.parts)
                   for r in self.wire_rounds)


def _check_caps(caps: np.ndarray) -> np.ndarray:
    caps = np.asarray(caps, np.int64)
    if caps.ndim != 2 or caps.shape[0] != caps.shape[1]:
        raise ValueError(f"caps must be [S, S], got {caps.shape}")
    if (caps < 0).any():
        raise ValueError("negative per-pair capacity")
    return caps


def _local_parts(caps: np.ndarray) -> tuple[RoundPart, ...]:
    return tuple(RoundPart(s, s, 0, int(caps[s, s]))
                 for s in range(caps.shape[0]) if caps[s, s] > 0)


def _mk_round(parts: list[RoundPart]) -> Round:
    return Round(tuple(parts), max(p.length for p in parts))


def rotation_schedule(caps: np.ndarray) -> RoundSchedule:
    """The diagonal schedule: round ``k`` ships diagonal
    ``(s, (s+k) mod S)`` padded to the diagonal's worst pair."""
    caps = _check_caps(caps)
    S = caps.shape[0]
    rounds = []
    for k in range(1, S):
        parts = [RoundPart(s, (s + k) % S, 0, int(caps[s, (s + k) % S]))
                 for s in range(S) if caps[s, (s + k) % S] > 0]
        if parts:
            rounds.append(_mk_round(parts))
    return RoundSchedule(S, "rotation", tuple(rounds), _local_parts(caps))


def greedy_schedule(caps: np.ndarray) -> RoundSchedule:
    """First-fit-decreasing bin packing of whole off-diagonal chunks.

    Chunks sorted by length descending (ties broken by (src, dest) for
    determinism) drop into the first round whose source and destination
    are both still free — coalescing the small diagonals the rotation
    schedule spreads over S−1 rounds. No chunk is split, so a round's
    padding is bounded by the spread of the lengths packed into it."""
    caps = _check_caps(caps)
    S = caps.shape[0]
    chunks = sorted(
        ((int(caps[s, d]), s, d) for s in range(S) for d in range(S)
         if s != d and caps[s, d] > 0),
        key=lambda c: (-c[0], c[1], c[2]))
    rounds: list[list[RoundPart]] = []
    srcs: list[set] = []
    dsts: list[set] = []
    for length, s, d in chunks:
        for i in range(len(rounds)):
            if s not in srcs[i] and d not in dsts[i]:
                rounds[i].append(RoundPart(s, d, 0, length))
                srcs[i].add(s)
                dsts[i].add(d)
                break
        else:
            rounds.append([RoundPart(s, d, 0, length)])
            srcs.append({s})
            dsts.append({d})
    return RoundSchedule(S, "greedy", tuple(_mk_round(r) for r in rounds),
                         _local_parts(caps))


def _perfect_matching(weight: np.ndarray) -> np.ndarray | None:
    """Kuhn's augmenting-path matching on the support of ``weight``.

    Returns ``match[src] = dest`` covering every source, or None if no
    perfect matching exists (cannot happen on a matrix with equal positive
    row/column sums — Birkhoff — but the caller guards anyway)."""
    S = weight.shape[0]
    match_of_dest = np.full(S, -1, np.int64)

    def augment(s: int, seen: np.ndarray) -> bool:
        for d in range(S):
            if weight[s, d] > 0 and not seen[d]:
                seen[d] = True
                if match_of_dest[d] < 0 or augment(int(match_of_dest[d]),
                                                   seen):
                    match_of_dest[d] = s
                    return True
        return False

    for s in range(S):
        if not augment(s, np.zeros(S, bool)):
            return None
    match = np.empty(S, np.int64)
    match[match_of_dest] = np.arange(S)
    return match


def bvn_schedule(caps: np.ndarray) -> RoundSchedule:
    """Birkhoff–von-Neumann decomposition: optimal Σ padded slots.

    Off-diagonal caps are padded with a slack matrix until every row and
    column sums to ``T = max(max row sum, max col sum)``; repeated perfect
    matchings peel off ``min matched value`` slots per round. Real chunks
    split across rounds at running lane offsets; matched slack means the
    device idles for that round. Total padded slots == T exactly."""
    caps = _check_caps(caps)
    S = caps.shape[0]
    real = caps.copy()
    np.fill_diagonal(real, 0)
    row = real.sum(1)
    col = real.sum(0)
    T = int(max(row.max(initial=0), col.max(initial=0)))
    if T == 0:
        return RoundSchedule(S, "bvn", (), _local_parts(caps))
    # slack: greedily top rows/cols up to T (a transportation fill — always
    # feasible since Σ(T - row) == Σ(T - col) == S·T − Σ real)
    slack = np.zeros((S, S), np.int64)
    need_r = T - row
    need_c = (T - col).copy()
    for s in range(S):
        r = int(need_r[s])
        for d in range(S):
            if r == 0:
                break
            take = min(r, int(need_c[d]))
            if take:
                slack[s, d] += take
                need_c[d] -= take
                r -= take
    rem_real = real.copy()
    used = np.zeros((S, S), np.int64)     # lanes of each chunk consumed
    rounds: list[Round] = []
    total = rem_real + slack
    while rem_real.sum() > 0:
        match = _perfect_matching(total)
        if match is None:                 # unreachable by Birkhoff; be safe
            return rotation_schedule(caps)
        c = int(min(total[s, match[s]] for s in range(S)))
        parts = []
        for s in range(S):
            d = int(match[s])
            r_take = min(c, int(rem_real[s, d]))
            if r_take:
                parts.append(RoundPart(s, d, int(used[s, d]), r_take))
                used[s, d] += r_take
                rem_real[s, d] -= r_take
                slack_take = c - r_take
            else:
                slack_take = c
            slack[s, d] -= slack_take
            total[s, d] -= c
        if parts:                          # all-slack matchings ship nothing
            rounds.append(_mk_round(parts))
    return RoundSchedule(S, "bvn", tuple(rounds), _local_parts(caps))


def best_schedule(caps: np.ndarray) -> RoundSchedule:
    """The schedule :class:`~repro_torch.comm.mesh_exchange.MeshExchange`
    executes: the candidate minimizing ``(wire_slots, n_rounds)``.

    The rotation schedule is always a candidate, so the result never
    exceeds the naive padded slot total (asserted). BvN is always a
    candidate, so the result always *hits* the Birkhoff lower bound on
    total slots; greedy wins the tie when it does so in fewer rounds."""
    caps = _check_caps(caps)
    cands = [rotation_schedule(caps), greedy_schedule(caps),
             bvn_schedule(caps)]
    best = min(cands, key=lambda sc: (sc.wire_slots, sc.n_rounds))
    naive = cands[0]
    assert best.wire_slots <= naive.wire_slots
    return best
