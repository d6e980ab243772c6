"""Degree-ordered directed graph (DODGr), sharded (paper Sec. 3 / 4.2).

Storage layout is *stacked*: every per-shard tensor carries a leading
shard axis ``S`` and all S logical shards live on one device. Vertices are
cyclic partitioned: owner ``v % S``, local row ``v // S``. Per the paper's
``Adj₊ᵐ`` the target vertex's metadata is stored on the edge (``tmeta``),
together with the target's full degree, hash and out-degree ``d₊``.

The host build is numpy and ends in ``torch.as_tensor(..., device=)``.
uint32 lanes (``nbr_h``, ``hub_nbr_h``) are stored as int32 tensors with
the same bits (see :mod:`repro_torch.utils`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graphs.csr import DeltaGraph, HostGraph
from repro_torch.utils import bucket_cap, ceil_div, resolve_device, splitmix32_np

PAD_ID = np.int32(2**31 - 1)  # sentinel target id for padded edge slots
PAD_D = np.int32(2**30)       # sentinel degree (sorts after everything real)

ORIENTS = ("degree", "stable")


def meta_widths(n_vp: int, n_vq: int, n_vr: int,
                n_epq: int, n_epr: int, n_eqr: int):
    """Wire-format entry widths in 4-byte words, shared by the engine and
    the host planner so push-vs-pull decisions agree byte for byte.

    (push_entry, row_entry, row_header, request_entry):
      push entry = q,r,key_d,key_h,p,ok + meta(p) + meta(pq) + meta(pr)
      row entry  = nbr,key_d,key_h + meta(q,v) + meta(v)
      row header = row_len + meta(q); request = q + ok
    """
    w_push = 6 + n_vp + n_epq + n_epr
    w_row = 3 + n_eqr + n_vr
    w_hdr = 2 + n_vq
    w_req = 2
    return w_push, w_row, w_hdr, w_req


def hub_widths(dvi: int, dvf: int, dei: int, def_: int,
               delta: bool = False) -> tuple[int, int]:
    """Replicated hub-table widths in 4-byte words: ``(w_elem, w_hdr)``."""
    w_elem = 3 + dei + def_ + dvi + dvf + (1 if delta else 0)
    w_hdr = 1 + dvi + dvf
    return w_elem, w_hdr


# field split: PER_SHARD fields carry the leading [S, ...] shard axis;
# REPLICATED fields are the hub tables (no shard axis)
PER_SHARD_FIELDS = (
    "row_ptr", "edge_src", "nbr", "nbr_d", "nbr_h", "nbr_dplus",
    "emeta_i", "emeta_f", "tmeta_i", "tmeta_f", "vmeta_i", "vmeta_f",
    "vdeg", "dplus", "nbr_new", "delta_gen", "nbr_hub",
)
REPLICATED_FIELDS = (
    "hub_row_len", "hub_nbr", "hub_nbr_d", "hub_nbr_h", "hub_nbr_new",
    "hub_eqr_i", "hub_eqr_f", "hub_tmeta_i", "hub_tmeta_f",
    "hub_vmeta_i", "hub_vmeta_f",
)
META_FIELDS = ("S", "n_global", "n_loc", "e_cap", "d_plus_max",
               "sample_p", "sample_seed", "orient", "epoch", "is_delta",
               "hub_theta", "n_hubs", "hub_len", "hub_rows")
# fields whose int32 storage holds uint32 bits
U32_FIELDS = ("nbr_h", "hub_nbr_h")


@dataclass(frozen=True)
class ShardedDODGr:
    """Stacked sharded DODGr + metadata. Leading axis of every per-shard
    tensor = shard."""

    # --- static ---
    S: int
    n_global: int
    n_loc: int
    e_cap: int
    d_plus_max: int
    # --- per-shard tensors ---
    row_ptr: torch.Tensor    # [S, n_loc+1] i32
    edge_src: torch.Tensor   # [S, e_cap] i32 global pivot id per edge slot
    nbr: torch.Tensor        # [S, e_cap] i32 global target id (row-sorted by key)
    nbr_d: torch.Tensor      # [S, e_cap] i32 target full degree
    nbr_h: torch.Tensor      # [S, e_cap] i32 bits of the u32 target hash
    nbr_dplus: torch.Tensor  # [S, e_cap] i32 target out-degree d₊
    emeta_i: torch.Tensor    # [S, e_cap, dei] i32
    emeta_f: torch.Tensor    # [S, e_cap, def] f32
    tmeta_i: torch.Tensor    # [S, e_cap, dvi] i32 (target vertex metadata)
    tmeta_f: torch.Tensor    # [S, e_cap, dvf] f32
    vmeta_i: torch.Tensor    # [S, n_loc, dvi] i32
    vmeta_f: torch.Tensor    # [S, n_loc, dvf] f32
    vdeg: torch.Tensor       # [S, n_loc] i32 full degree of local vertex
    dplus: torch.Tensor      # [S, n_loc] i32 out-degree of local vertex
    # --- delta overlay (epoch-aware ingestion) ---
    nbr_new: torch.Tensor    # [S, e_cap] bool: edge arrived this epoch
    delta_gen: torch.Tensor  # [S, e_cap] bool: edge may open a new-triangle wedge
    # --- hub delegation: the Adj₊ rows of every vertex of degree ≥
    # hub_theta, replicated (no shard axis), so wedges centred on a hub
    # close on the source shard ---
    nbr_hub: torch.Tensor      # [S, e_cap] i32 hub-table row of target, -1 if none
    hub_row_len: torch.Tensor  # [Hc] i32
    hub_nbr: torch.Tensor      # [Hc, hub_len] i32
    hub_nbr_d: torch.Tensor    # [Hc, hub_len] i32
    hub_nbr_h: torch.Tensor    # [Hc, hub_len] i32 bits of u32
    hub_nbr_new: torch.Tensor  # [Hc, hub_len] bool
    hub_eqr_i: torch.Tensor    # [Hc, hub_len, dei] i32
    hub_eqr_f: torch.Tensor    # [Hc, hub_len, def] f32
    hub_tmeta_i: torch.Tensor  # [Hc, hub_len, dvi] i32
    hub_tmeta_f: torch.Tensor  # [Hc, hub_len, dvf] f32
    hub_vmeta_i: torch.Tensor  # [Hc, dvi] i32
    hub_vmeta_f: torch.Tensor  # [Hc, dvf] f32
    # --- provenance (static), cross-checked against the plan ---
    sample_p: float = 1.0
    sample_seed: int = 0
    orient: str = "degree"
    epoch: int = 0
    is_delta: bool = False
    hub_theta: int = 0
    n_hubs: int = 0
    hub_len: int = 1
    hub_rows: str = "frontier"

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device


@dataclass(frozen=True)
class RoutingStats:
    """Host-side facts the engine needs to pick static superstep counts."""

    wedges_total: int
    max_stream: int
    max_pairs: int
    edges_per_shard: np.ndarray  # [S]
    wedge_per_shard: np.ndarray  # [S]


def orient_edges(g: HostGraph, orient: str = "degree"):
    """Host orientation of every undirected edge by the ``<₊`` key.

    ``"degree"`` is the paper's ``(deg, hash, id)`` key; ``"stable"`` the
    epoch-stable ``(0, hash, id)`` key. Returns ``(p, q, okey, h)``.
    """
    if orient not in ORIENTS:
        raise ValueError(f"orient must be one of {ORIENTS}, got {orient!r}")
    deg = (g.degrees() if orient == "degree"
           else np.zeros(g.n, np.int64))
    h = splitmix32_np(np.arange(g.n, dtype=np.uint32)).astype(np.int64)
    u, v = g.src, g.dst
    ku = np.stack([deg[u], h[u], u], 1)
    kv = np.stack([deg[v], h[v], v], 1)
    u_first = (
        (ku[:, 0] < kv[:, 0])
        | ((ku[:, 0] == kv[:, 0]) & (ku[:, 1] < kv[:, 1]))
        | ((ku[:, 0] == kv[:, 0]) & (ku[:, 1] == kv[:, 1]) & (ku[:, 2] < kv[:, 2]))
    )
    p = np.where(u_first, u, v)
    q = np.where(u_first, v, u)
    return p, q, deg, h


def sparsify_edges(g: HostGraph, p: float, seed: int = 0) -> HostGraph:
    """DOULION sparsification: keep each undirected edge i.i.d. with
    probability ``p``; the result is stamped with ``(sample_p,
    sample_seed)`` and a stamped graph passes through untouched."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"sample_p must be in (0, 1], got {p}")
    if g.sample_p != 1.0:
        if p != 1.0 and (g.sample_p, g.sample_seed) != (p, seed):
            raise ValueError(
                f"graph already sparsified with (p, seed)="
                f"({g.sample_p}, {g.sample_seed}); cannot re-sparsify with "
                f"({p}, {seed})")
        return g
    if p >= 1.0:
        return g
    rng = np.random.default_rng(seed)
    keep = rng.random(g.m) < p
    return HostGraph(g.n, g.src[keep], g.dst[keep], g.spec,
                     g.vmeta_i, g.vmeta_f, g.emeta_i[keep], g.emeta_f[keep],
                     sample_p=p, sample_seed=seed)


def delta_gen_mask(q_s: np.ndarray, row_start: np.ndarray, row_len: np.ndarray,
                   new_s: np.ndarray, touched: np.ndarray) -> np.ndarray:
    """Per-edge wedge-generator mask for a delta frontier, in shard-sorted
    edge order: the edge is new, a later edge of its row is new, or ``q``
    is a delta endpoint and a later edge of the row targets one."""
    if len(q_s) == 0:
        return np.zeros(0, bool)
    idx = np.arange(len(q_s))
    row_end = np.repeat(row_start + row_len, row_len)
    cum = np.cumsum(new_s.astype(np.int64))
    suffix_new = (cum[row_end - 1] - cum[idx]) > 0
    t_q = touched[q_s]
    cum_t = np.cumsum(t_q.astype(np.int64))
    suffix_touched = (cum_t[row_end - 1] - cum_t[idx]) > 0
    return new_s | suffix_new | (t_q & suffix_touched)


class HubTableCache:
    """Replicate-once, refresh-on-touch hub tables across delta epochs.

    Keeps the oriented union adjacency on the host (seeded once from the
    base graph, then advanced by each epoch's overlay in O(batch) inserts)
    and serves hub rows out of it: an untouched hub's row is copied as it
    is (the stable key ``(0, hash(v), v)`` never moves and metadata is
    immutable); a touched hub's row already holds the inserted edges, and
    only its newness flags are recomputed against the epoch's delta edges.

    Served rows are the hub's full union ``Adj₊``, a superset of the
    frontier row a rebuild would give. The delta engine stays exact: an
    extra table hit closes a triangle whose three edges are old (a new
    ``pq`` or ``pr`` puts ``q`` and ``r`` in the touched set, so ``qr`` is
    in the frontier row too), and the hub fold's ≥ 1-new-edge mask drops
    exactly those. Requires ``orient="stable"``: under the degree key rows
    reorder, and the hub set moves, as batches arrive.
    """

    def __init__(self, base: HostGraph, orient: str = "stable"):
        if orient != "stable":
            raise ValueError(
                "HubTableCache requires orient='stable': union rows are "
                "only epoch-stable under the (0, hash, id) key — the "
                f"degree key reorders rows as batches arrive (got "
                f"{orient!r})")
        self.orient = orient
        self.at_epoch = 0         # the last overlay folded in
        self.rows_reused = 0      # cumulative: rows served as they were
        self.rows_refreshed = 0   # cumulative: rows with newness recomputed
        self.last_build: dict = {}
        self._rows: dict[int, dict] = {}   # pivot -> sorted union Adj₊ row
        self._vmeta_i = np.asarray(base.vmeta_i)
        self._vmeta_f = np.asarray(base.vmeta_f)
        self._dei, self._def = base.spec.dei, base.spec.def_
        self._new_keys = np.zeros(0, np.int64)   # this epoch's delta edges
        self._touched_pivots: set = set()
        self._ingest(base.src, base.dst, base.emeta_i, base.emeta_f)

    @staticmethod
    def _orient_stable(src, dst):
        """Per-edge stable orientation, :func:`orient_edges`'s with the
        zero degree component."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        h_u = splitmix32_np(src.astype(np.uint32)).astype(np.int64)
        h_v = splitmix32_np(dst.astype(np.uint32)).astype(np.int64)
        u_first = (h_u < h_v) | ((h_u == h_v) & (src < dst))
        p = np.where(u_first, src, dst)
        q = np.where(u_first, dst, src)
        hq = np.where(u_first, h_v, h_u)
        return p, q, hq

    def _ingest(self, src, dst, emeta_i, emeta_f) -> np.ndarray:
        """Insert oriented edges into their pivot rows, each row kept
        sorted by (hash, id), the shard layer's order within a row.
        Returns the distinct pivots whose rows changed."""
        if len(src) == 0:
            return np.zeros(0, np.int64)
        p, q, hq = self._orient_stable(src, dst)
        emeta_i = np.asarray(emeta_i, np.int32).reshape(len(p), self._dei)
        emeta_f = np.asarray(emeta_f, np.float32).reshape(len(p), self._def)
        order = np.lexsort((q, hq, p))
        p, q, hq = p[order], q[order], hq[order]
        emeta_i, emeta_f = emeta_i[order], emeta_f[order]
        piv, starts = np.unique(p, return_index=True)
        bounds = np.append(starts, len(p))
        for i, v in enumerate(piv):
            lo, hi = bounds[i], bounds[i + 1]
            add = dict(nbr=q[lo:hi], h=hq[lo:hi].astype(np.uint32),
                       eqr_i=emeta_i[lo:hi], eqr_f=emeta_f[lo:hi])
            row = self._rows.get(int(v))
            if row is None:
                self._rows[int(v)] = add
                continue
            nbr = np.concatenate([row["nbr"], add["nbr"]])
            h = np.concatenate([row["h"], add["h"]])
            srt = np.lexsort((nbr, h.astype(np.int64)))
            self._rows[int(v)] = dict(
                nbr=nbr[srt], h=h[srt],
                eqr_i=np.concatenate([row["eqr_i"], add["eqr_i"]])[srt],
                eqr_f=np.concatenate([row["eqr_f"], add["eqr_f"]])[srt])
        return piv

    def advance(self, dg: DeltaGraph) -> None:
        """Fold one epoch's overlay into the union rows. Idempotent at the
        current epoch; epochs must arrive in order, with no gap."""
        if dg.epoch == self.at_epoch:
            return
        if dg.epoch != self.at_epoch + 1:
            raise ValueError(
                f"HubTableCache is at epoch {self.at_epoch} but the delta "
                f"graph is at epoch {dg.epoch}; advance() must see every "
                "epoch in order")
        piv = self._ingest(dg.d_src, dg.d_dst, dg.d_emeta_i, dg.d_emeta_f)
        p, q, _ = self._orient_stable(dg.d_src, dg.d_dst)
        # sorted once, so that build() looks rows up by binary search (an
        # isin a row re-sorts the whole batch: minutes for a 3.8 M-edge one)
        self._new_keys = np.sort((p << np.int64(32)) | q)
        self._touched_pivots = set(int(v) for v in piv)
        # the vertex set may have grown; existing rows of vmeta never change
        self._vmeta_i = np.asarray(dg.base.vmeta_i)
        self._vmeta_f = np.asarray(dg.base.vmeta_f)
        self.at_epoch = dg.epoch

    def build(self, hub_ids: np.ndarray) -> dict:
        """The replicated ``hub_*`` arrays of this epoch's hub set, from the
        cached union rows: the ``hub_tables`` argument of
        :func:`shard_dodgr`. Untouched rows are served as they are
        (``rows_reused``); touched rows get their newness recomputed
        (``rows_refreshed``)."""
        hub_ids = np.asarray(hub_ids, np.int64)
        n_hubs = len(hub_ids)
        hc = max(1, n_hubs)
        rows = [self._rows.get(int(v)) for v in hub_ids]
        lens = [0 if r is None else len(r["nbr"]) for r in rows]
        hub_len = max(1, max(lens, default=1))
        dvi, dvf = self._vmeta_i.shape[1], self._vmeta_f.shape[1]
        t = dict(
            hub_row_len=np.zeros(hc, np.int32),
            hub_nbr=np.full((hc, hub_len), PAD_ID, np.int32),
            hub_nbr_d=np.full((hc, hub_len), PAD_D, np.int32),
            hub_nbr_h=np.zeros((hc, hub_len), np.uint32),
            hub_nbr_new=np.zeros((hc, hub_len), bool),
            hub_eqr_i=np.zeros((hc, hub_len, self._dei), np.int32),
            hub_eqr_f=np.zeros((hc, hub_len, self._def), np.float32),
            hub_tmeta_i=np.zeros((hc, hub_len, dvi), np.int32),
            hub_tmeta_f=np.zeros((hc, hub_len, dvf), np.float32),
            hub_vmeta_i=np.zeros((hc, dvi), np.int32),
            hub_vmeta_f=np.zeros((hc, dvf), np.float32),
        )
        reused = refreshed = 0
        for i, (v, row) in enumerate(zip(hub_ids, rows)):
            if row is None:
                reused += 1
                continue
            k = lens[i]
            t["hub_row_len"][i] = k
            t["hub_nbr"][i, :k] = row["nbr"]
            t["hub_nbr_d"][i, :k] = 0   # stable key: degree component is 0
            t["hub_nbr_h"][i, :k] = row["h"]
            t["hub_eqr_i"][i, :k] = row["eqr_i"]
            t["hub_eqr_f"][i, :k] = row["eqr_f"]
            t["hub_tmeta_i"][i, :k] = self._vmeta_i[row["nbr"]]
            t["hub_tmeta_f"][i, :k] = self._vmeta_f[row["nbr"]]
            if int(v) in self._touched_pivots:
                key = (np.int64(v) << np.int64(32)) | row["nbr"]
                at = np.searchsorted(self._new_keys, key)
                t["hub_nbr_new"][i, :k] = self._new_keys[
                    np.minimum(at, len(self._new_keys) - 1)] == key
                refreshed += 1
            else:
                reused += 1
        if n_hubs:
            t["hub_vmeta_i"][:n_hubs] = self._vmeta_i[hub_ids]
            t["hub_vmeta_f"][:n_hubs] = self._vmeta_f[hub_ids]
        self.rows_reused += reused
        self.rows_refreshed += refreshed
        self.last_build = dict(epoch=self.at_epoch, n_hubs=n_hubs,
                               rows_reused=reused, rows_refreshed=refreshed)
        t.update(hub_ids=hub_ids, hub_len=hub_len, hub_rows="union")
        return t

    def nbytes(self) -> int:
        """Host bytes of the cached union rows."""
        return sum(int(a.nbytes) for row in self._rows.values()
                   for a in row.values())


def shard_dodgr(g: HostGraph, S: int, e_cap: int | None = None,
                sample_p: float = 1.0, sample_seed: int = 0,
                edge_new: np.ndarray | None = None, orient: str = "degree",
                epoch: int = 0,
                hub_theta: int = 0,
                hub_tables: dict | None = None,
                cap_policy: str = "exact",
                e_cap_floor: int = 0,
                d_plus_max_floor: int = 0,
                device=None,
                ) -> tuple[ShardedDODGr, RoutingStats]:
    """Host-side ingestion: orient, partition cyclically, build padded CSR
    shards, and place them on ``device`` (``None`` = the CUDA device; it
    raises when there is none).

    Arguments and semantics are those of the JAX package's ``shard_dodgr``:
    ``sample_p`` ingests a DOULION view, ``edge_new`` a delta frontier,
    ``hub_theta ≥ 1`` builds the replicated hub tables, ``cap_policy=
    "bucket"`` rounds ``e_cap``/``d_plus_max``/``hub_len`` up to the
    bucket grid, ``hub_tables`` (a :meth:`HubTableCache.build` result)
    substitutes cache-served union rows for the inline hub-table build.
    """
    dev = resolve_device(device)
    if cap_policy not in ("exact", "bucket"):
        raise ValueError(f"cap_policy must be 'exact' or 'bucket', "
                         f"got {cap_policy!r}")
    g = sparsify_edges(g, sample_p, sample_seed)
    sample_p, sample_seed = g.sample_p, g.sample_seed
    p, q, deg, h = orient_edges(g, orient)
    d_plus = np.bincount(p, minlength=g.n).astype(np.int64)

    owner = (p % S).astype(np.int64)
    local = (p // S).astype(np.int64)
    n_loc = ceil_div(g.n, S)

    # sort edges by (owner, local row, key(q)) so shard rows are contiguous+sorted
    order = np.lexsort((q, h[q], deg[q], local, owner))
    p_s, q_s = p[order], q[order]
    owner_s, local_s = owner[order], local[order]

    counts = np.bincount(owner_s, minlength=S)
    e_cap_needed = int(counts.max()) if len(counts) else 0
    if e_cap is None:
        e_cap = max(8, int(np.ceil(e_cap_needed / 8.0) * 8))
        if cap_policy == "bucket":
            e_cap = bucket_cap(e_cap)
        e_cap = max(e_cap, int(e_cap_floor))
    if e_cap < e_cap_needed:
        raise ValueError(f"e_cap {e_cap} < required {e_cap_needed}")

    start = np.zeros(S + 1, np.int64)
    start[1:] = np.cumsum(counts)

    alloc = np.full
    nbr = alloc((S, e_cap), PAD_ID, np.int32)
    nbr_d = alloc((S, e_cap), PAD_D, np.int32)
    nbr_h = alloc((S, e_cap), 0, np.uint32)
    nbr_dp = alloc((S, e_cap), 0, np.int32)
    edge_src = alloc((S, e_cap), PAD_ID, np.int32)
    dei, def_, dvi, dvf = (g.spec.dei, g.spec.def_, g.spec.dvi, g.spec.dvf)
    emeta_i = alloc((S, e_cap, dei), 0, np.int32)
    emeta_f = alloc((S, e_cap, def_), 0, np.float32)
    tmeta_i = alloc((S, e_cap, dvi), 0, np.int32)
    tmeta_f = alloc((S, e_cap, dvf), 0, np.float32)
    row_ptr = alloc((S, n_loc + 1), 0, np.int32)
    vmeta_i = alloc((S, n_loc, dvi), 0, np.int32)
    vmeta_f = alloc((S, n_loc, dvf), 0, np.float32)
    vdeg = alloc((S, n_loc), 0, np.int32)
    dplus_arr = alloc((S, n_loc), 0, np.int32)
    nbr_new = alloc((S, e_cap), False, bool)
    # all-true for a static snapshot (only read in delta mode)
    delta_gen = alloc((S, e_cap), edge_new is None, bool)

    emeta_i_src = g.emeta_i[order]
    emeta_f_src = g.emeta_f[order]

    row_key = owner_s * n_loc + local_s
    _, row_start_idx, row_len = np.unique(row_key, return_index=True, return_counts=True)
    pos_in_row = np.arange(len(p_s)) - np.repeat(row_start_idx, row_len)
    suffix = np.repeat(row_len, row_len) - pos_in_row - 1

    if edge_new is not None:
        new_s = np.asarray(edge_new, bool)[order]
        touched = np.zeros(g.n, bool)
        touched[g.src[edge_new]] = True
        touched[g.dst[edge_new]] = True
        gen_s = delta_gen_mask(q_s, row_start_idx, row_len, new_s, touched)
    else:
        new_s = gen_s = None

    # --- hub table: replicate Adj₊ rows of heavy vertices (deg ≥ θ) ---
    if hub_theta < 0:
        raise ValueError(f"hub_theta must be ≥ 0, got {hub_theta}")
    n_hubs = 0
    hub_ids = np.zeros(0, np.int64)
    if hub_theta >= 1:
        tdeg = deg if orient == "degree" else g.degrees()
        hub_ids = np.nonzero(tdeg >= hub_theta)[0]
        n_hubs = len(hub_ids)
    hc = max(1, n_hubs)
    hub_rows = "frontier"
    hub_len = 1
    hub_of_q = None
    if n_hubs:
        hub_id_of = np.full(g.n, -1, np.int32)
        hub_id_of[hub_ids] = np.arange(n_hubs, dtype=np.int32)
        hub_of_q = hub_id_of[q_s]
    if hub_tables is not None and hub_theta >= 1:
        if not np.array_equal(np.asarray(hub_tables["hub_ids"], np.int64),
                              hub_ids.astype(np.int64)):
            raise ValueError(
                "hub_tables was built for a different hub set than "
                f"deg ≥ {hub_theta} selects in this view; build it from "
                "this epoch's frontier degrees")
        hub_rows = str(hub_tables["hub_rows"])
        hub_len = int(hub_tables["hub_len"])
        hub_row_len = np.asarray(hub_tables["hub_row_len"], np.int32)
        hub_nbr = np.asarray(hub_tables["hub_nbr"], np.int32)
        hub_nbr_d = np.asarray(hub_tables["hub_nbr_d"], np.int32)
        hub_nbr_h = np.asarray(hub_tables["hub_nbr_h"], np.uint32)
        hub_nbr_new = np.asarray(hub_tables["hub_nbr_new"], bool)
        hub_eqr_i = np.asarray(hub_tables["hub_eqr_i"], np.int32)
        hub_eqr_f = np.asarray(hub_tables["hub_eqr_f"], np.float32)
        hub_tmeta_i = np.asarray(hub_tables["hub_tmeta_i"], np.int32)
        hub_tmeta_f = np.asarray(hub_tables["hub_tmeta_f"], np.float32)
        hub_vmeta_i = np.asarray(hub_tables["hub_vmeta_i"], np.int32)
        hub_vmeta_f = np.asarray(hub_tables["hub_vmeta_f"], np.float32)
    else:
        hub_row_len = np.zeros(hc, np.int32)
        if n_hubs:
            hub_row_len[:n_hubs] = d_plus[hub_ids]
            hub_len = max(1, int(d_plus[hub_ids].max()))
            if cap_policy == "bucket":
                hub_len = bucket_cap(hub_len)
        hub_nbr = alloc((hc, hub_len), PAD_ID, np.int32)
        hub_nbr_d = alloc((hc, hub_len), PAD_D, np.int32)
        hub_nbr_h = alloc((hc, hub_len), 0, np.uint32)
        hub_nbr_new = alloc((hc, hub_len), False, bool)
        hub_eqr_i = alloc((hc, hub_len, dei), 0, np.int32)
        hub_eqr_f = alloc((hc, hub_len, def_), 0, np.float32)
        hub_tmeta_i = alloc((hc, hub_len, dvi), 0, np.int32)
        hub_tmeta_f = alloc((hc, hub_len, dvf), 0, np.float32)
        hub_vmeta_i = alloc((hc, dvi), 0, np.int32)
        hub_vmeta_f = alloc((hc, dvf), 0, np.float32)
        if n_hubs:
            he = np.nonzero(hub_id_of[p_s] >= 0)[0]
            hid = hub_id_of[p_s[he]]
            hpos = pos_in_row[he]
            hub_nbr[hid, hpos] = q_s[he]
            hub_nbr_d[hid, hpos] = deg[q_s[he]]
            hub_nbr_h[hid, hpos] = h[q_s[he]].astype(np.uint32)
            hub_eqr_i[hid, hpos] = emeta_i_src[he]
            hub_eqr_f[hid, hpos] = emeta_f_src[he]
            hub_tmeta_i[hid, hpos] = g.vmeta_i[q_s[he]]
            hub_tmeta_f[hid, hpos] = g.vmeta_f[q_s[he]]
            hub_vmeta_i[:n_hubs] = g.vmeta_i[hub_ids]
            hub_vmeta_f[:n_hubs] = g.vmeta_f[hub_ids]
            if new_s is not None:
                hub_nbr_new[hid, hpos] = new_s[he]
    nbr_hub = alloc((S, e_cap), -1, np.int32)

    for s in range(S):
        lo, hi = start[s], start[s + 1]
        k = hi - lo
        nbr[s, :k] = q_s[lo:hi]
        nbr_d[s, :k] = deg[q_s[lo:hi]]
        nbr_h[s, :k] = h[q_s[lo:hi]].astype(np.uint32)
        nbr_dp[s, :k] = d_plus[q_s[lo:hi]]
        edge_src[s, :k] = p_s[lo:hi]
        emeta_i[s, :k] = emeta_i_src[lo:hi]
        emeta_f[s, :k] = emeta_f_src[lo:hi]
        tmeta_i[s, :k] = g.vmeta_i[q_s[lo:hi]]
        tmeta_f[s, :k] = g.vmeta_f[q_s[lo:hi]]
        if new_s is not None:
            nbr_new[s, :k] = new_s[lo:hi]
            delta_gen[s, :k] = gen_s[lo:hi]
            delta_gen[s, k:] = False
        if hub_of_q is not None:
            nbr_hub[s, :k] = hub_of_q[lo:hi]
        rows = np.bincount(local_s[lo:hi], minlength=n_loc)
        row_ptr[s, 1:] = np.cumsum(rows)
        ids = np.arange(s, g.n, S, dtype=np.int64)
        nv = len(ids)
        vmeta_i[s, :nv] = g.vmeta_i[ids]
        vmeta_f[s, :nv] = g.vmeta_f[ids]
        vdeg[s, :nv] = deg[ids]
        dplus_arr[s, :nv] = d_plus[ids]

    # --- routing stats for static superstep planning ---
    dest = (q_s % S).astype(np.int64)
    sd = owner_s * S + dest
    stream = np.bincount(sd, weights=suffix, minlength=S * S).astype(np.int64)
    pairs = np.bincount(sd, minlength=S * S)
    stats = RoutingStats(
        wedges_total=int(suffix.sum()),
        max_stream=int(stream.max()) if len(stream) else 0,
        max_pairs=int(pairs.max()) if len(pairs) else 0,
        edges_per_shard=counts,
        wedge_per_shard=np.bincount(owner_s, weights=suffix, minlength=S).astype(np.int64),
    )

    d_plus_max = max(1, int(d_plus.max()) if g.n else 0)
    if cap_policy == "bucket":
        d_plus_max = bucket_cap(d_plus_max)
    d_plus_max = max(d_plus_max, int(d_plus_max_floor))
    arrays = dict(
        row_ptr=row_ptr, edge_src=edge_src, nbr=nbr, nbr_d=nbr_d,
        nbr_h=nbr_h, nbr_dplus=nbr_dp, emeta_i=emeta_i, emeta_f=emeta_f,
        tmeta_i=tmeta_i, tmeta_f=tmeta_f, vmeta_i=vmeta_i, vmeta_f=vmeta_f,
        vdeg=vdeg, dplus=dplus_arr, nbr_new=nbr_new, delta_gen=delta_gen,
        nbr_hub=nbr_hub, hub_row_len=hub_row_len, hub_nbr=hub_nbr,
        hub_nbr_d=hub_nbr_d, hub_nbr_h=hub_nbr_h, hub_nbr_new=hub_nbr_new,
        hub_eqr_i=hub_eqr_i, hub_eqr_f=hub_eqr_f, hub_tmeta_i=hub_tmeta_i,
        hub_tmeta_f=hub_tmeta_f, hub_vmeta_i=hub_vmeta_i,
        hub_vmeta_f=hub_vmeta_f)
    meta = dict(
        S=S, n_global=g.n, n_loc=n_loc, e_cap=e_cap, d_plus_max=d_plus_max,
        sample_p=sample_p, sample_seed=sample_seed, orient=orient,
        epoch=epoch, is_delta=edge_new is not None, hub_theta=hub_theta,
        n_hubs=n_hubs, hub_len=hub_len, hub_rows=hub_rows)
    return dodgr_from_arrays(arrays, meta, dev), stats


def shard_delta(dg: DeltaGraph, S: int, e_cap: int | None = None,
                orient: str = "stable",
                hub_theta: int = 0,
                hub_cache: HubTableCache | None = None,
                cap_policy: str = "exact",
                e_cap_floor: int = 0,
                d_plus_max_floor: int = 0,
                device=None,
                ) -> tuple[ShardedDODGr, RoutingStats]:
    """Shard the epoch's delta frontier with the snapshot's cyclic owner
    map and stamp its epoch; ``device`` as in :func:`shard_dodgr`.

    The default orientation is the epoch-stable key, which every epoch of
    a delta sequence must share for ``merge_epochs`` to equal a full
    recompute bit for bit. ``hub_theta`` replicates heavy frontier rows
    (degree in the frontier); pass ``plan_delta``'s ``cfg.hub_theta``.
    ``hub_cache`` (a :class:`HubTableCache` seeded from the stream's base)
    serves the hub rows from the cache, advanced to this epoch, instead
    of rebuilding them; it requires ``orient="stable"``.
    """
    h, edge_new = dg.frontier()
    hub_tables = None
    if hub_cache is not None and hub_theta >= 1:
        if orient != "stable":
            raise ValueError(
                "shard_delta(hub_cache=...) requires orient='stable' — "
                "union hub rows are only epoch-stable under the "
                f"(0, hash, id) key (got {orient!r})")
        hub_cache.advance(dg)
        hub_tables = hub_cache.build(
            np.nonzero(h.degrees() >= hub_theta)[0])
    return shard_dodgr(h, S, e_cap=e_cap, edge_new=edge_new, orient=orient,
                       epoch=dg.epoch, hub_theta=hub_theta,
                       hub_tables=hub_tables, cap_policy=cap_policy,
                       e_cap_floor=e_cap_floor,
                       d_plus_max_floor=d_plus_max_floor, device=device)


def dodgr_from_arrays(arrays: dict, meta: dict, device) -> ShardedDODGr:
    """Place host arrays on ``device`` as a :class:`ShardedDODGr`; uint32
    arrays become int32 tensors holding the same bits."""
    dev = torch.device(device)
    kw = {}
    for f in PER_SHARD_FIELDS + REPLICATED_FIELDS:
        a = np.ascontiguousarray(arrays[f])
        if not a.flags.writeable:
            a = a.copy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        kw[f] = torch.as_tensor(a, device=dev)
    kw.update({f: meta[f] for f in META_FIELDS})
    return ShardedDODGr(**kw)


def shard_slice(gr: ShardedDODGr, rank: int, device=None) -> ShardedDODGr:
    """Rank ``rank``'s part of a stacked :class:`ShardedDODGr`, for the mesh
    lowering (one shard per rank): row ``rank`` of every per-shard field,
    keeping a leading axis of 1; the replicated hub tables whole; the
    static fields as they are (``S`` stays the true shard count). Only
    the slice goes to ``device`` (``None``: where ``gr`` lies); the
    per-shard rows are copies, so the slice holds none of the stack."""
    if not 0 <= rank < gr.S:
        raise ValueError(f"rank {rank} is not a shard of S={gr.S}")
    dev = gr.device if device is None else resolve_device(device)
    kw = {f: getattr(gr, f) for f in META_FIELDS}
    for f in PER_SHARD_FIELDS:
        kw[f] = getattr(gr, f)[rank:rank + 1].to(dev, copy=True)
    for f in REPLICATED_FIELDS:
        kw[f] = getattr(gr, f).to(dev)
    return ShardedDODGr(**kw)
