"""Transports for the survey engine's superstep exchanges (stacked layout).

The engine's communication pattern is one dest-major buffer exchange per
superstep: each source shard emits, per destination shard, a block of
fixed-width entries; the transport routes block (s, d) to shard ``d`` and,
for the pull phase, routes per-slot replies back along the inverse path.
With all S shards stacked on one device, a transport is a reshape
(``dense``) or an indexed gather (``ragged``) of the ``[S, slots, ...]``
buffers; both deliver the same entries. The third transport, ``mesh``
(:mod:`repro_torch.comm.mesh_exchange`), routes ragged's maps through
real collectives, one shard per ``torch.distributed`` rank. The static
maps are host numpy, built exactly as the JAX package builds them.
"""
from __future__ import annotations

import numpy as np
import torch

TRANSPORTS = ("dense", "ragged", "mesh")


class Exchange:
    """Static routing for one dest-major exchange lane.

    ``S``          shard count
    ``out_cap``    send-buffer slots per shard per round (padded max)
    ``in_cap``     recv-buffer slots per shard per round (padded max)
    ``caps``       [S, S] per-(src, dest) slots per round
    ``dest_of``    [S, out_cap] destination shard of slot j (S = padding)
    ``lane_of``    [S, out_cap] rank of slot j within its (s, d) block
    ``cap_of``     [S, out_cap] block capacity of slot j (0 on padding)
    ``block_off``  [S, S] offset of dest-d's block in s's send buffer
    ``in_off``     [S_dest, S_src] offset of src-s's block in d's recv buffer
    ``recv_ok``    [S, in_cap] bool or None — valid recv slots (None = all)
    """

    name: str
    S: int
    out_cap: int
    in_cap: int
    caps: np.ndarray
    dest_of: np.ndarray
    lane_of: np.ndarray
    cap_of: np.ndarray
    block_off: np.ndarray
    in_off: np.ndarray
    recv_ok: np.ndarray | None

    def tensor(self, name: str, device, dtype=torch.int32) -> torch.Tensor:
        """A static map as a tensor on ``device``, built once per device."""
        cache = self.__dict__.setdefault("_tensors", {})
        key = (name, str(device), dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(np.array(getattr(self, name)),
                                         dtype=dtype, device=device)
        return cache[key]

    def scatter(self, tree: dict) -> dict:
        """Route send buffers to owners: ``[S, out_cap, ...] → [S, in_cap, ...]``."""
        raise NotImplementedError

    def gather(self, tree: dict) -> dict:
        """Route per-recv-slot replies back along the inverse path:
        ``[S, in_cap, ...] → [S, out_cap, ...]``."""
        raise NotImplementedError

    def round_slots(self) -> int:
        """Wire slots (block padding included) shipped per round, summed
        over every (src, dest) pair — the measured exchange volume."""
        return int(np.asarray(self.caps, np.int64).sum())

    def apply_recv_ok(self, ok: torch.Tensor) -> torch.Tensor:
        """Mask a delivered ``ok`` field with recv-slot validity."""
        if self.recv_ok is None:
            return ok
        return ok & self.tensor("recv_ok", ok.device, torch.bool)


class DenseExchange(Exchange):
    """The swapaxes all-to-all: one global per-pair capacity."""

    name = "dense"

    def __init__(self, S: int, cap: int):
        cap = max(1, int(cap))
        self.S, self.cap = S, cap
        self.out_cap = self.in_cap = S * cap
        self.caps = np.full((S, S), cap, np.int64)
        j = np.arange(S * cap, dtype=np.int32)
        self.dest_of = np.broadcast_to(j // cap, (S, S * cap))
        self.lane_of = np.broadcast_to(j % cap, (S, S * cap))
        self.cap_of = np.full((S, S * cap), cap, np.int32)
        self.block_off = np.broadcast_to(
            np.arange(S, dtype=np.int32) * cap, (S, S))
        self.in_off = np.broadcast_to(
            np.arange(S, dtype=np.int64) * cap, (S, S))
        self.recv_ok = None

    def scatter(self, tree: dict) -> dict:
        S, cap = self.S, self.cap

        def one(x):
            y = x.reshape((S, S, cap) + tuple(x.shape[2:])).transpose(0, 1)
            return y.reshape((S, S * cap) + tuple(x.shape[2:]))

        return {k: one(v) for k, v in tree.items()}

    def gather(self, tree: dict) -> dict:
        # swapaxes is an involution on the (src, owner) block grid
        return self.scatter(tree)


class RaggedExchange(Exchange):
    """Per-(src, dest) static capacities; compaction via indexed routing."""

    name = "ragged"

    def __init__(self, caps: np.ndarray):
        caps = np.asarray(caps, np.int64)
        if caps.ndim != 2 or caps.shape[0] != caps.shape[1]:
            raise ValueError(f"caps must be [S, S], got {caps.shape}")
        if (caps < 0).any():
            raise ValueError("negative per-pair capacity")
        S = caps.shape[0]
        self.S, self.caps = S, caps
        out_len = caps.sum(1)
        in_len = caps.sum(0)
        self.out_cap = max(1, int(out_len.max()))
        self.in_cap = max(1, int(in_len.max()))
        self.block_off = np.zeros((S, S), np.int32)
        self.block_off[:, 1:] = np.cumsum(caps[:, :-1], 1)
        in_off = np.zeros((S, S), np.int64)        # [dest, src]
        in_off[:, 1:] = np.cumsum(caps.T[:, :-1], 1)
        self.in_off = in_off

        self.dest_of = np.full((S, self.out_cap), S, np.int32)
        self.lane_of = np.zeros((S, self.out_cap), np.int32)
        self.cap_of = np.zeros((S, self.out_cap), np.int32)
        self._back_slot = np.zeros((S, self.out_cap), np.int32)
        for s in range(S):
            for d in range(S):
                c = int(caps[s, d])
                if c == 0:
                    continue
                lo = self.block_off[s, d]
                self.dest_of[s, lo:lo + c] = d
                self.lane_of[s, lo:lo + c] = np.arange(c)
                self.cap_of[s, lo:lo + c] = c
                self._back_slot[s, lo:lo + c] = in_off[d, s] + np.arange(c)
        self._src_idx = np.zeros((S, self.in_cap), np.int32)
        self._slot_idx = np.zeros((S, self.in_cap), np.int32)
        self.recv_ok = np.zeros((S, self.in_cap), bool)
        for d in range(S):
            for s in range(S):
                c = int(caps[s, d])
                if c == 0:
                    continue
                lo = int(in_off[d, s])
                self._src_idx[d, lo:lo + c] = s
                self._slot_idx[d, lo:lo + c] = self.block_off[s, d] + np.arange(c)
                self.recv_ok[d, lo:lo + c] = True
        self._back_src = np.where(self.dest_of < S, self.dest_of, 0)

    def _route(self, tree: dict, rows: str, cols: str) -> dict:
        out = {}
        for k, x in tree.items():
            out[k] = x[self.tensor(rows, x.device, torch.int64),
                       self.tensor(cols, x.device, torch.int64)]
        return out

    def scatter(self, tree: dict) -> dict:
        return self._route(tree, "_src_idx", "_slot_idx")

    def gather(self, tree: dict) -> dict:
        return self._route(tree, "_back_src", "_back_slot")


def make_exchange(transport: str, S: int, cap: int, caps=None, mesh=None,
                  lanes: tuple[str, str] = ("scatter", "gather")) -> Exchange:
    """Build the transport for one exchange lane: ``dense`` uses the
    uniform ``cap``; ``ragged`` requires the planner's per-(src, dest)
    ``caps``; ``mesh`` is the real-collective transport
    (:class:`~repro_torch.comm.mesh_exchange.MeshExchange`): ragged's
    static maps (a uniform ``cap`` grid when no per-pair caps are
    planned), routed by collectives over ``mesh`` (a
    ``launch.mesh.ShardMesh``); ``lanes`` names its scatter and gather in
    the mesh's byte counters."""
    if transport == "dense":
        return DenseExchange(S, cap)
    if transport == "ragged":
        if caps is None:
            raise ValueError(
                "ragged transport needs per-(shard, dest) capacities — build "
                "the plan with pushpull.plan_engine(..., transport='ragged')")
        return RaggedExchange(np.asarray(caps, np.int64).reshape(S, S))
    if transport == "mesh":
        from repro_torch.comm.mesh_exchange import MeshExchange
        if caps is None:
            caps = np.full((S, S), max(1, int(cap)), np.int64)
        return MeshExchange(np.asarray(caps, np.int64).reshape(S, S),
                            mesh=mesh, lanes=lanes)
    raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
