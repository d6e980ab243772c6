"""Host-side graph container and metadata schema.

``HostGraph`` is the ingestion format: an undirected simple graph as a
deduplicated edge list with struct-of-arrays metadata; ``DeltaGraph`` is
an epoch sequence of them (an immutable base and the batch that arrived
this epoch). Both are host numpy; the device build starts in
:mod:`repro_torch.core.dodgr`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from repro_torch.utils import splitmix32_np


@dataclass(frozen=True)
class MetaSpec:
    """Names of the fixed-width metadata columns, in storage order."""

    v_int: tuple = ()
    v_float: tuple = ()
    e_int: tuple = ()
    e_float: tuple = ()

    @property
    def dvi(self):
        return len(self.v_int)

    @property
    def dvf(self):
        return len(self.v_float)

    @property
    def dei(self):
        return len(self.e_int)

    @property
    def def_(self):
        return len(self.e_float)


@dataclass
class HostGraph:
    """Undirected simple graph with metadata, host (numpy) resident.

    Edges are stored once per undirected pair with ``src < dst``.
    """

    n: int
    src: np.ndarray  # [m] int64
    dst: np.ndarray  # [m]
    spec: MetaSpec = field(default_factory=MetaSpec)
    vmeta_i: np.ndarray | None = None  # [n, dvi] int32
    vmeta_f: np.ndarray | None = None  # [n, dvf] float32
    emeta_i: np.ndarray | None = None  # [m, dei] int32
    emeta_f: np.ndarray | None = None  # [m, def] float32
    # DOULION provenance, stamped by ``dodgr.sparsify_edges``
    sample_p: float = 1.0
    sample_seed: int = 0

    def __post_init__(self):
        m = len(self.src)
        if self.vmeta_i is None:
            self.vmeta_i = np.zeros((self.n, self.spec.dvi), np.int32)
        if self.vmeta_f is None:
            self.vmeta_f = np.zeros((self.n, self.spec.dvf), np.float32)
        if self.emeta_i is None:
            self.emeta_i = np.zeros((m, self.spec.dei), np.int32)
        if self.emeta_f is None:
            self.emeta_f = np.zeros((m, self.spec.def_), np.float32)

    @property
    def m(self) -> int:
        """Undirected edge count."""
        return len(self.src)

    @staticmethod
    def from_edges(n, src, dst, spec=MetaSpec(), emeta_i=None, emeta_f=None,
                   vmeta_i=None, vmeta_f=None, dedup_keep="first"):
        """Canonicalize an arbitrary (possibly multi/looped) edge list.

        Self loops are dropped. Parallel edges keep the ``first``
        occurrence or the ``min_float0``-valued one (earliest timestamp).
        """
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if emeta_i is not None:
            emeta_i = np.asarray(emeta_i, np.int32)[keep]
        if emeta_f is not None:
            emeta_f = np.asarray(emeta_f, np.float32)[keep]
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        key = lo * np.int64(n) + hi
        if dedup_keep == "min_float0":
            assert emeta_f is not None and emeta_f.shape[1] >= 1
            order = np.lexsort((emeta_f[:, 0], key))
        else:
            order = np.argsort(key, kind="stable")
        key_sorted = key[order]
        first = np.ones(len(key_sorted), bool)
        first[1:] = key_sorted[1:] != key_sorted[:-1]
        sel = order[first]
        return HostGraph(
            n=n,
            src=lo[sel],
            dst=hi[sel],
            spec=spec,
            emeta_i=None if emeta_i is None else emeta_i[sel],
            emeta_f=None if emeta_f is None else emeta_f[sel],
            vmeta_i=vmeta_i,
            vmeta_f=vmeta_f,
        )

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.n, np.int64)
        np.add.at(deg, self.src, 1)
        np.add.at(deg, self.dst, 1)
        return deg

    def vertex_hashes(self) -> np.ndarray:
        return splitmix32_np(np.arange(self.n, dtype=np.uint32))

    def with_degree_meta(self, col: str = "degree") -> "HostGraph":
        """Attach each vertex's degree as an int metadata column (Sec 5.9)."""
        deg = self.degrees().astype(np.int32)
        spec = MetaSpec(
            v_int=self.spec.v_int + (col,),
            v_float=self.spec.v_float,
            e_int=self.spec.e_int,
            e_float=self.spec.e_float,
        )
        vmeta_i = np.concatenate([self.vmeta_i, deg[:, None]], axis=1)
        return HostGraph(self.n, self.src, self.dst, spec, vmeta_i,
                         self.vmeta_f, self.emeta_i, self.emeta_f,
                         sample_p=self.sample_p, sample_seed=self.sample_seed)

    def to_networkx(self):
        import networkx as nx

        g = nx.Graph()
        g.add_nodes_from(range(self.n))
        g.add_edges_from(zip(self.src.tolist(), self.dst.tolist()))
        return g

    def append_edges(self, src, dst, emeta_i=None, emeta_f=None, n=None,
                     vmeta_i=None, vmeta_f=None) -> "DeltaGraph":
        """Start an epoch sequence: this graph becomes the immutable base and
        the batch becomes the epoch-1 delta overlay.

        The batch is canonicalized like :meth:`from_edges` (loops dropped,
        ``src < dst``, batch-internal duplicates keep the first occurrence)
        and edges the base already holds are dropped: re-arrivals are not
        new, so the union stays simple and no triangle is counted twice.
        ``n`` (or a batch endpoint past ``self.n``) grows the vertex set;
        ``vmeta_i``/``vmeta_f`` replace the vertex metadata at the grown
        size (default: zero rows for the new vertices).
        """
        base = self
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        n_new = int(max(self.n, n or 0,
                        (src.max() + 1) if len(src) else 0,
                        (dst.max() + 1) if len(dst) else 0))
        if n_new > self.n or vmeta_i is not None or vmeta_f is not None:
            if vmeta_i is None:
                vmeta_i = np.concatenate(
                    [self.vmeta_i,
                     np.zeros((n_new - self.n, self.spec.dvi), np.int32)])
            if vmeta_f is None:
                vmeta_f = np.concatenate(
                    [self.vmeta_f,
                     np.zeros((n_new - self.n, self.spec.dvf), np.float32)])
            base = HostGraph(n_new, self.src, self.dst, self.spec,
                             np.asarray(vmeta_i, np.int32),
                             np.asarray(vmeta_f, np.float32),
                             self.emeta_i, self.emeta_f,
                             sample_p=self.sample_p,
                             sample_seed=self.sample_seed)
        batch = HostGraph.from_edges(n_new, src, dst, spec=self.spec,
                                     emeta_i=emeta_i, emeta_f=emeta_f)
        # drop batch edges the base already holds (n-independent 64-bit key)
        bkey = (batch.src << np.int64(32)) | batch.dst
        gkey = (base.src << np.int64(32)) | base.dst
        fresh = ~np.isin(bkey, gkey)
        return DeltaGraph(
            base=base,
            d_src=batch.src[fresh], d_dst=batch.dst[fresh],
            d_emeta_i=batch.emeta_i[fresh], d_emeta_f=batch.emeta_f[fresh],
            epoch=1,
        )


@dataclass(frozen=True)
class DeltaGraph:
    """Epoch-aware graph: an immutable base (every edge of epochs before
    ``epoch``) plus a compact overlay (the edges that arrived this epoch).

    ``union()`` is the full snapshot a one-shot recompute would poll;
    ``frontier()`` is the subgraph the incremental engine traverses
    instead: every triangle with a new edge has all three edges incident
    to an endpoint of the overlay, so the overlay plus the base edges that
    touch one of its endpoints hold exactly the new triangles (and some old
    ones, which the engine masks out).
    """

    base: HostGraph
    d_src: np.ndarray    # [b] int64 canonical (src < dst), disjoint from base
    d_dst: np.ndarray
    d_emeta_i: np.ndarray  # [b, dei] int32
    d_emeta_f: np.ndarray  # [b, def] float32
    epoch: int = 1

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def spec(self) -> MetaSpec:
        return self.base.spec

    @property
    def m(self) -> int:
        """Union (cumulative) undirected edge count."""
        return self.base.m + len(self.d_src)

    @property
    def m_delta(self) -> int:
        """Edges that arrived this epoch."""
        return len(self.d_src)

    @cached_property
    def _union(self) -> HostGraph:
        # the base's DOULION stamp survives the append
        return HostGraph(
            self.n,
            np.concatenate([self.base.src, self.d_src]),
            np.concatenate([self.base.dst, self.d_dst]),
            self.spec, self.base.vmeta_i, self.base.vmeta_f,
            np.concatenate([self.base.emeta_i, self.d_emeta_i]),
            np.concatenate([self.base.emeta_f, self.d_emeta_f]),
            sample_p=self.base.sample_p, sample_seed=self.base.sample_seed,
        )

    def union(self) -> HostGraph:
        """The full snapshot as of this epoch (base ∪ overlay), cached."""
        return self._union

    def touched(self) -> np.ndarray:
        """[n] bool: vertices incident to a delta edge (V(D))."""
        t = np.zeros(self.n, bool)
        t[self.d_src] = True
        t[self.d_dst] = True
        return t

    @cached_property
    def _frontier(self) -> tuple[HostGraph, np.ndarray]:
        t = self.touched()
        keep = t[self.base.src] | t[self.base.dst]
        h = HostGraph(
            self.n,
            np.concatenate([self.base.src[keep], self.d_src]),
            np.concatenate([self.base.dst[keep], self.d_dst]),
            self.spec, self.base.vmeta_i, self.base.vmeta_f,
            np.concatenate([self.base.emeta_i[keep], self.d_emeta_i]),
            np.concatenate([self.base.emeta_f[keep], self.d_emeta_f]),
            sample_p=self.base.sample_p, sample_seed=self.base.sample_seed,
        )
        edge_new = np.zeros(h.m, bool)
        edge_new[int(keep.sum()):] = True
        return h, edge_new

    def frontier(self) -> tuple[HostGraph, np.ndarray]:
        """(H, edge_new): the overlay plus the base edges incident to its
        endpoints, and each edge's newness. Every triangle of the union
        with a new edge lies in H, under the same orientation, once.
        Cached, so ``shard_delta`` and ``plan_delta`` share one build."""
        return self._frontier

    def append_edges(self, src, dst, emeta_i=None, emeta_f=None, n=None,
                     vmeta_i=None, vmeta_f=None) -> "DeltaGraph":
        """Advance one epoch: the overlay folds into the base and the new
        batch becomes the next overlay."""
        nxt = self.union().append_edges(src, dst, emeta_i=emeta_i,
                                        emeta_f=emeta_f, n=n,
                                        vmeta_i=vmeta_i, vmeta_f=vmeta_f)
        return DeltaGraph(base=nxt.base, d_src=nxt.d_src, d_dst=nxt.d_dst,
                          d_emeta_i=nxt.d_emeta_i, d_emeta_f=nxt.d_emeta_f,
                          epoch=self.epoch + 1)
