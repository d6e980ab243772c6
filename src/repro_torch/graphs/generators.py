"""Synthetic graph generators (paper Sec 5.2 / 5.5 stand-ins).

R-MAT is the paper's weak-scaling workload; ``a, b, c`` default to the
Graph500 parameters. Every generator draws from ``numpy`` with a seed, so
the arrays equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import HostGraph, MetaSpec


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         spec: MetaSpec = MetaSpec()) -> HostGraph:
    """R-MAT generator [Chakrabarti et al. 2004] — recursive quadrant sampling."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        u = rng.random(m)
        v = rng.random(m)
        src_bit = u > (a + b)            # rows: top (a+b) vs bottom (c+d)
        thr_top = a / (a + b)
        d_ = 1.0 - a - b - c
        thr_bot = c / (c + d_)
        dst_bit = np.where(src_bit, v > thr_bot, v > thr_top)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    return HostGraph.from_edges(n, src, dst, spec=spec)


def erdos_renyi(n: int, m: int, seed: int = 0, spec: MetaSpec = MetaSpec()) -> HostGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m * 2)
    dst = rng.integers(0, n, m * 2)
    return HostGraph.from_edges(n, src[:m], dst[:m], spec=spec)


def clique(k: int, spec: MetaSpec = MetaSpec()) -> HostGraph:
    idx = np.arange(k)
    src, dst = np.meshgrid(idx, idx, indexing="ij")
    keep = src < dst
    return HostGraph.from_edges(k, src[keep], dst[keep], spec=spec)


def temporal_social(n: int, m: int, seed: int = 0,
                    t_max: float = 1.0e6) -> HostGraph:
    """Timestamped preferential-attachment-ish social graph.

    Edge metadata: float column 0 = timestamp. Vertex metadata: int column
    0 = community label.
    """
    rng = np.random.default_rng(seed)
    spec = MetaSpec(v_int=("label",), e_float=("ts",))
    zipf = 1.0 / np.sqrt(np.arange(1, n + 1))
    p = zipf / zipf.sum()
    src = rng.choice(n, 2 * m, p=p)
    dst = rng.choice(n, 2 * m)
    ts = np.sort(rng.random(2 * m).astype(np.float32)) * t_max
    g = HostGraph.from_edges(n, src, dst, spec=spec,
                             emeta_f=ts[:, None], dedup_keep="min_float0")
    labels = rng.integers(0, 16, g.n).astype(np.int32)
    g.vmeta_i = labels[:, None]
    return g


def karate(spec: MetaSpec = MetaSpec()) -> HostGraph:
    import networkx as nx  # lazy: only this generator needs networkx

    g = nx.karate_club_graph()
    e = np.array(g.edges(), np.int64)
    return HostGraph.from_edges(g.number_of_nodes(), e[:, 0], e[:, 1], spec=spec)
