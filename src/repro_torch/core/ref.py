"""Pure-Python oracle for triangle surveys (test reference).

Enumerates every triangle of a :class:`HostGraph` in canonical DODGr order
``p <₊ q <₊ r`` and invokes a callback with the six metadata items — the
paper's semantics (Alg. 1) at laptop scale, with no distribution.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import HostGraph
from repro_torch.utils import splitmix32_np


def dodgr_adjacency(g: HostGraph, orient: str = "degree"):
    """Oriented adjacency: adj[p] = list of q with p <₊ q, sorted by key(q)."""
    deg = (g.degrees() if orient == "degree"
           else np.zeros(g.n, np.int64))
    h = splitmix32_np(np.arange(g.n, dtype=np.uint32)).astype(np.int64)
    key = np.stack([deg, h, np.arange(g.n, dtype=np.int64)], 1)

    def less(u, v):
        return tuple(key[u]) < tuple(key[v])

    adj: dict[int, list[int]] = {v: [] for v in range(g.n)}
    eidx: dict[tuple[int, int], int] = {}
    for i, (u, v) in enumerate(zip(g.src.tolist(), g.dst.tolist())):
        p, q = (u, v) if less(u, v) else (v, u)
        adj[p].append(q)
        eidx[(p, q)] = i
    for p in adj:
        adj[p].sort(key=lambda q: tuple(key[q]))
    return adj, eidx, key


def survey_triangles_ref(g: HostGraph, callback, orient: str = "degree") -> int:
    """Run ``callback(p, q, r, meta)`` on every triangle; returns the count.

    ``meta`` holds vmeta_i/f for p, q, r and emeta_i/f for pq, pr, qr.
    """
    adj, eidx, _ = dodgr_adjacency(g, orient)
    count = 0
    for p, nbrs in adj.items():
        for j, q in enumerate(nbrs):
            q_adj = set(adj[q])
            for r in nbrs[j + 1:]:
                if r in q_adj:
                    count += 1
                    if callback is not None:
                        e_pq, e_pr, e_qr = eidx[(p, q)], eidx[(p, r)], eidx[(q, r)]
                        meta = dict(
                            v_i=(g.vmeta_i[p], g.vmeta_i[q], g.vmeta_i[r]),
                            v_f=(g.vmeta_f[p], g.vmeta_f[q], g.vmeta_f[r]),
                            e_i=(g.emeta_i[e_pq], g.emeta_i[e_pr], g.emeta_i[e_qr]),
                            e_f=(g.emeta_f[e_pq], g.emeta_f[e_pr], g.emeta_f[e_qr]),
                            e_idx=(e_pq, e_pr, e_qr),
                        )
                        callback(p, q, r, meta)
    return count


def count_triangles_ref(g: HostGraph, orient: str = "degree") -> int:
    return survey_triangles_ref(g, None, orient)


def new_triangle_classes_ref(g: HostGraph, edge_new: np.ndarray,
                             orient: str = "stable") -> dict:
    """Triangles by how many of their edges arrived this epoch:
    ``{"noo": new-old-old, "nno": new-new-old, "nnn": new-new-new,
    "old": no new edge}`` (the delta engine's oracle)."""
    out = {"noo": 0, "nno": 0, "nnn": 0, "old": 0}

    def cb(p, q, r, meta):
        k = sum(bool(edge_new[i]) for i in meta["e_idx"])
        out[("old", "noo", "nno", "nnn")[k]] += 1

    survey_triangles_ref(g, cb, orient)
    return out


def wedge_count_ref(g: HostGraph, orient: str = "degree") -> int:
    """|W₊| — DODGr wedge checks, the engine's work unit (paper Sec. 3)."""
    adj, _, _ = dodgr_adjacency(g, orient)
    return sum(len(v) * (len(v) - 1) // 2 for v in adj.values())
