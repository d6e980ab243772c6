"""Mesh transport: the third :class:`~repro_torch.comm.exchange.Exchange`.

The ``dense`` and ``ragged`` transports *model* the exchange on the stacked
``[S, ...]`` layout, every shard on one device. :class:`MeshExchange` runs
the same static routing with **real collectives**, one shard per
``torch.distributed`` rank (``launch.mesh.make_shard_mesh``):

``uniform caps`` (a dense plan relabelled ``mesh``)
    one ``all_to_all_single`` on the rank's ``[S·cap, ...]`` send block:
    block d goes to rank d, and rank s's block lands at offset ``s·cap``,
    exactly the dense recv layout. Replies take the same call back: on the
    (src, dest) block grid it is an involution.

``ragged caps`` (a ragged or mesh plan)
    the physical rounds of a :class:`~repro_torch.comm.round_schedule.
    RoundSchedule` (``best_schedule``, the JAX package's scheduler): one
    ``batch_isend_irecv`` per round, each source of the round's partial
    permutation shipping its padded slice of ``round.slots`` slots to its
    destination. The receiver compacts the slice at its static ``in_off +
    lane_lo`` offset with an index copy that drops the padding slots, so
    the recv buffer on every live slot is the stacked ragged layout, and
    everything downstream (``recv_ok`` masking, reply routing) is shared
    with :class:`~repro_torch.comm.exchange.RaggedExchange`, whose static
    maps this class inherits. The self diagonal is a local copy and never
    reaches the wire. Rounds run in order (the JAX package issues round
    r+1 before compacting round r; that changes no result).

Every leaf of an exchanged dict travels in one ``[slots, W]`` int32 word
buffer: ``bool`` leaves as int32 words (the JAX package ships them the
same way), float32 leaves as their bits, so one collective moves a whole
exchange and each wire slot is the planner's ``W`` 4-byte words.

Backend: under ``nccl`` device tensors go to the collectives as they are.
Under ``gloo`` with the shards on a card, the mesh copies each operand to
host memory and each delivered buffer back to the device (gloo's send and
receive take a host pointer); the copies are timed apart from the
collectives (``ShardMesh.counters``). The bytes handed to the collectives
are counted per lane: the port's evidence that the schedule is what runs.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.exchange import Exchange, RaggedExchange
from repro_torch.comm.round_schedule import (RoundSchedule, best_schedule,
                                             rotation_schedule)


def pack_words(tree: dict) -> tuple[torch.Tensor, list]:
    """Leaves ``[1, slots, ...]`` (int32, float32 or bool) → one
    ``[slots, W]`` int32 buffer and the layout to unpack it."""
    cols, layout = [], []
    for key, x in tree.items():
        tail = tuple(x.shape[2:])
        w = int(np.prod(tail, dtype=np.int64))
        y = x[0]
        if y.dtype == torch.bool:
            y = y.to(torch.int32)
        elif y.dtype == torch.float32:
            y = y.view(torch.int32)
        elif y.dtype != torch.int32:
            raise TypeError(f"mesh wire: leaf {key!r} is {y.dtype}; the wire "
                            "carries 4-byte words and bools")
        cols.append(y.reshape(y.shape[0], w))
        layout.append((key, x.dtype, tail, w))
    return torch.cat(cols, 1), layout


def unpack_words(buf: torch.Tensor, layout: list) -> dict:
    """Inverse of :func:`pack_words` for a delivered ``[slots, W]``
    buffer: contiguous ``[1, slots, ...]`` leaves."""
    out, c = {}, 0
    n = buf.shape[0]
    for key, dtype, tail, w in layout:
        y = buf[:, c:c + w].contiguous()
        c += w
        if dtype == torch.bool:
            y = y != 0
        elif dtype == torch.float32:
            y = y.view(torch.float32)
        out[key] = y.reshape((1, n) + tail)
    return out


class MeshExchange(RaggedExchange):
    """Collective transport over ``torch.distributed``, one shard per rank.

    Static maps are :class:`RaggedExchange`'s: a uniform ``caps`` grid
    reproduces the dense block layout bit for bit. ``scatter`` / ``gather``
    run on a rank through :meth:`local_view`, which slices the static maps
    to the rank's row. ``mesh`` is a ``launch.mesh.ShardMesh`` (rank, size,
    backend, device, counters); without one the exchange still answers
    every static-map query. ``lanes`` names the scatter and the gather in
    the mesh's byte counters."""

    name = "mesh"

    def __init__(self, caps: np.ndarray, mesh=None,
                 lanes: tuple[str, str] = ("scatter", "gather")):
        super().__init__(caps)
        self.mesh = mesh
        self.lanes = lanes
        S = self.S
        caps = np.asarray(self.caps, np.int64)
        self.uniform = bool((caps == caps[0, 0]).all() and caps[0, 0] >= 1)
        # the scheduler's best of three candidates (never worse than the
        # rotation), and the rotation kept for the padding comparison
        self.schedule: RoundSchedule = best_schedule(caps)
        self.naive_schedule: RoundSchedule = rotation_schedule(caps)
        # per-round maps, as the JAX package builds them: slice [lane_lo,
        # lane_lo + len) of pair (s, d) rides lanes [0, len) of the
        # round's padded [slots] operand
        self._rounds = []
        for rnd in self.schedule.wire_rounds:
            ck = rnd.slots
            send = np.zeros((S, ck), np.int32)
            recv = np.full((S, ck), self.in_cap, np.int32)   # in_cap = drop
            gsend = np.zeros((S, ck), np.int32)
            grecv = np.full((S, ck), self.out_cap, np.int32)
            for p in rnd.parts:
                lane = p.lane_lo + np.arange(p.length)
                send[p.src, :p.length] = self.block_off[p.src, p.dest] + lane
                grecv[p.src, :p.length] = self.block_off[p.src, p.dest] + lane
                recv[p.dest, :p.length] = self.in_off[p.dest, p.src] + lane
                gsend[p.dest, :p.length] = self.in_off[p.dest, p.src] + lane
            self._rounds.append(dict(
                ck=ck, send=send, recv=recv, gsend=gsend, grecv=grecv,
                fwd=[(p.src, p.dest) for p in rnd.parts],
                bwd=[(p.dest, p.src) for p in rnd.parts]))
        # resident self diagonal: one local copy, never on the wire
        self._local = None
        dparts = self.schedule.local_parts
        dk = max((p.length for p in dparts), default=0)
        if dk:
            dsend = np.zeros((S, dk), np.int32)
            drecv = np.full((S, dk), self.in_cap, np.int32)
            dgsend = np.zeros((S, dk), np.int32)
            dgrecv = np.full((S, dk), self.out_cap, np.int32)
            for p in dparts:
                lane = np.arange(p.length)
                dsend[p.src, :p.length] = self.block_off[p.src, p.src] + lane
                drecv[p.src, :p.length] = self.in_off[p.src, p.src] + lane
                dgsend[p.src, :p.length] = self.in_off[p.src, p.src] + lane
                dgrecv[p.src, :p.length] = self.block_off[p.src, p.src] + lane
            self._local = dict(send=dsend, recv=drecv, gsend=dgsend,
                               grecv=dgrecv)
        self._plans = {}

    # -- wire accounting ----------------------------------------------------

    def wire_round_slots(self) -> int:
        """Slots per *rank* per superstep when every rank holds each
        round's padded operand, as the JAX package counts them (uniform:
        the whole all-to-all block, self chunk included; ragged: the
        schedule's padded slots, self diagonal excluded)."""
        if self.uniform:
            return self.out_cap
        return self.schedule.wire_slots

    def sent_round_slots(self) -> int:
        """Slots handed to the collectives per superstep, summed over
        ranks: ``S · S·cap`` for the uniform all-to-all (self chunks
        included), and for the scheduled rounds each source's padded
        slice, ``Σ_rounds len(parts) · slots`` (a rank that is no source
        of a round sends nothing in it)."""
        if self.uniform:
            return self.S * self.out_cap
        return sum(len(r.parts) * r.slots for r in self.schedule.wire_rounds)

    # -- rank-local routing -------------------------------------------------

    def _plan(self, rank: int, direction: str, device) -> dict:
        """Rank ``rank``'s routing for one direction (``fwd``: scatter,
        ``bwd``: gather) as index tensors on ``device``, built once: per
        round, the peer it sends to and the slots it reads, the peer it
        receives from and where the live slots land; and the local copy."""
        key = (rank, direction, str(device))
        if key in self._plans:
            return self._plans[key]
        fwd = direction == "fwd"
        s_key, r_key = ("send", "recv") if fwd else ("gsend", "grecv")
        out_len = self.in_cap if fwd else self.out_cap

        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        rounds = []
        for r in self._rounds:
            perm = r["fwd"] if fwd else r["bwd"]
            send_to = next((d for s, d in perm if s == rank), None)
            recv_from = next((s for s, d in perm if d == rank), None)
            dst = r[r_key][rank]
            keep = np.flatnonzero(dst < out_len)
            rounds.append(dict(
                ck=r["ck"], send_to=send_to, recv_from=recv_from,
                send_idx=idx(r[s_key][rank]) if send_to is not None else None,
                keep=idx(keep) if recv_from is not None else None,
                dst=idx(dst[keep]) if recv_from is not None else None))
        local = None
        if self._local is not None:
            dst = self._local[r_key][rank]
            keep = np.flatnonzero(dst < out_len)
            if len(keep):
                local = dict(src=idx(self._local[s_key][rank][keep]),
                             dst=idx(dst[keep]))
        plan = self._plans[key] = dict(rounds=rounds, local=local,
                                       out_len=out_len)
        return plan

    def _route(self, rank: int, tree: dict, direction: str) -> dict:
        mesh = self.mesh
        if mesh is None:
            raise ValueError("a MeshExchange routes on a rank of a mesh: "
                             "build it with make_exchange('mesh', ..., "
                             "mesh=launch.mesh.make_shard_mesh(S))")
        lane = self.lanes[0 if direction == "fwd" else 1]
        buf, layout = pack_words(tree)
        W = buf.shape[1]
        if self.uniform:
            # one all-to-all: block d of the send buffer to rank d; rank s's
            # block lands at s·cap (an involution on the block grid)
            w_in = mesh.to_wire(buf)
            w_out = torch.empty_like(w_in)
            mesh.count(lane, w_in)
            t0 = time.perf_counter()
            dist.all_to_all_single(w_out, w_in, group=mesh.group)
            mesh.waited(t0)
            return unpack_words(mesh.from_wire(w_out), layout)
        plan = self._plan(rank, direction, buf.device)
        out = torch.zeros((plan["out_len"], W), dtype=torch.int32,
                          device=buf.device)
        for r in plan["rounds"]:
            ops, got = [], None
            if r["send_to"] is not None:
                seg = mesh.to_wire(buf[r["send_idx"]])
                mesh.count(lane, seg)
                ops.append(dist.P2POp(dist.isend, seg, r["send_to"],
                                      mesh.group))
            if r["recv_from"] is not None:
                got = torch.empty((r["ck"], W), dtype=torch.int32,
                                  device=mesh.wire_device)
                ops.append(dist.P2POp(dist.irecv, got, r["recv_from"],
                                      mesh.group))
            if not ops:
                continue
            t0 = time.perf_counter()
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            mesh.waited(t0)
            if got is not None:
                got = mesh.from_wire(got)
                out[r["dst"]] = got[r["keep"]]
        if plan["local"] is not None:
            out[plan["local"]["dst"]] = buf[plan["local"]["src"]]
        return unpack_words(out, layout)

    def local_view(self, rank: int) -> "LocalMeshView":
        """The rank's :class:`Exchange`: static maps sliced to its row
        (leading axis 1, as the rank's graph slice), ``scatter`` and
        ``gather`` bound to the collectives."""
        return LocalMeshView(self, rank)


class LocalMeshView(Exchange):
    """One rank's window onto a :class:`MeshExchange`.

    Send-side maps carry a leading axis of 1 so the engine treats the rank
    as a one-shard stack; ``caps`` and ``block_off`` keep the rank's whole
    ``[1, S]`` destination row, since slot → dest routing needs every
    pair's capacity. ``in_off`` stays the global ``[S, S]``."""

    def __init__(self, parent: MeshExchange, rank: int):
        self.parent = parent
        self.rank = rank
        self.name = parent.name
        self.S = parent.S
        self.out_cap = parent.out_cap
        self.in_cap = parent.in_cap
        self.in_off = parent.in_off
        row = slice(rank, rank + 1)
        self.dest_of = parent.dest_of[row]
        self.lane_of = parent.lane_of[row]
        self.cap_of = parent.cap_of[row]
        self.caps = np.asarray(parent.caps)[row]
        self.block_off = parent.block_off[row]
        self.recv_ok = (None if parent.recv_ok is None
                        else parent.recv_ok[row])

    def scatter(self, tree: dict) -> dict:
        return self.parent._route(self.rank, tree, "fwd")

    def gather(self, tree: dict) -> dict:
        return self.parent._route(self.rank, tree, "bwd")

    def round_slots(self) -> int:
        return self.parent.round_slots()
