"""Fanout neighbor sampler (GraphSAGE-style) for ``minibatch_lg``.

The twin of ``repro.graphs.sampler``, numpy on the host: the production
pattern is CPU-side sampling feeding the accelerator with padded
static-shape subgraph tensors; the device never sees dynamic shapes.
Layered sampling with fanouts (15, 10): seeds → up to 15 neighbors each
→ up to 10 neighbors of those, deduplicated into a compact node list
with remapped edge indices.

Given the same ``numpy.random.Generator`` state, :func:`sample_subgraph`
draws what the reference draws and returns its subgraph bit for bit.
:meth:`CSRHost.from_graph` fills the rows with one stable sort by source
where the reference loops over every edge; each row lists its
neighbours in the reference's order (as ``src``, then as ``dst``, each
in edge order).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graphs.csr import HostGraph


@dataclass
class CSRHost:
    indptr: np.ndarray
    indices: np.ndarray

    @staticmethod
    def from_graph(g: HostGraph) -> "CSRHost":
        u = np.concatenate([g.src, g.dst]).astype(np.int64)
        v = np.concatenate([g.dst, g.src]).astype(np.int64)
        indptr = np.zeros(g.n + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(u, minlength=g.n))
        indices = v[np.argsort(u, kind="stable")]
        return CSRHost(indptr, indices)


def sample_subgraph(csr: CSRHost, seeds: np.ndarray, fanouts: tuple,
                    rng: np.random.Generator):
    """Returns (nodes, edge_src, edge_dst, edge_valid, n_seeds) with static
    padded shapes determined by seeds×fanouts. Edge indices are *local*
    (into ``nodes``); sampled edges point child → parent (message flow
    toward seeds)."""
    caps = [len(seeds)]
    for f in fanouts:
        caps.append(caps[-1] * f)
    node_cap = sum(caps)
    e_cap = sum(caps[1:])

    nodes = np.full(node_cap, -1, np.int64)
    nodes[: len(seeds)] = seeds
    local = {int(s): i for i, s in enumerate(seeds)}
    n_nodes = len(seeds)
    src_l = np.zeros(e_cap, np.int32)
    dst_l = np.zeros(e_cap, np.int32)
    valid = np.zeros(e_cap, bool)
    n_edges = 0
    frontier = list(range(len(seeds)))

    for f in fanouts:
        nxt = []
        for li in frontier:
            v = int(nodes[li])
            lo, hi = csr.indptr[v], csr.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            k = min(f, deg)
            picks = rng.choice(deg, size=k, replace=False) + lo
            for e in picks:
                nb = int(csr.indices[e])
                if nb not in local:
                    local[nb] = n_nodes
                    nodes[n_nodes] = nb
                    n_nodes += 1
                    nxt.append(local[nb])
                src_l[n_edges] = local[nb]
                dst_l[n_edges] = li
                valid[n_edges] = True
                n_edges += 1
        frontier = nxt

    return dict(nodes=nodes, edge_src=src_l, edge_dst=dst_l,
                edge_valid=valid, n_nodes=n_nodes, n_edges=n_edges,
                n_seeds=len(seeds))
