"""Host-side graph container and metadata schema.

``HostGraph`` is the ingestion format: an undirected simple graph as a
deduplicated edge list with struct-of-arrays metadata. It is host numpy;
the device build starts in :func:`repro_torch.core.dodgr.shard_dodgr`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

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

    def append_edges(self, *args, **kwargs):
        raise NotImplementedError(
            "delta epochs (DeltaGraph, shard_delta, plan_delta, "
            "survey_delta) are not ported yet; see ROADMAP.md, Queue 1 "
            "item 6")
