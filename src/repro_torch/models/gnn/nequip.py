"""NequIP [arXiv:2101.03164]: E(3)-equivariant interatomic potential.

The twin of ``repro.models.gnn.nequip``. Brief config: n_layers=5,
d_hidden=32 channels, l_max=2, n_rbf=8, cutoff=5. Features are irreps
[N, C, (l_max+1)²]; each interaction layer couples node features with
edge spherical harmonics through real Clebsch-Gordan tensor products
(:mod:`~repro_torch.models.gnn.so3`), radially modulated per path (Bessel
RBF → MLP), scatter-summed to destinations, then mixed linearly per
output l with a gated nonlinearity (scalars: silu; l>0: sigmoid-gated
by dedicated scalars). The contractions are ``torch.einsum`` with the
reference's subscripts; parameters and module as in ``schnet.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import threefry
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (
    GraphBatch,
    bessel_rbf,
    cosine_cutoff,
    edge_vectors,
    segment_mp,
    segment_sum,
)
from repro_torch.models.layers import ParamTree, truncated_normal
from repro_torch.utils import resolve_device


def tp_paths(l_max: int):
    """All coupling paths (l1, l2, l3) with l1,l3 ≤ l_max, l2 ≤ l_max."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                paths.append((l1, l2, l3))
    return paths


def _dense(key, din, dout):
    return dict(w=truncated_normal(key, (din, dout), 1.0 / np.sqrt(din)),
                b=torch.zeros(dout, dtype=torch.float32))


def _apply(p, x):
    return x @ p["w"] + p["b"]


@dataclass(frozen=True)
class Cfg:
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 32
    d_feat: int = 0
    d_out: int = 1
    radial_hidden: int = 32


def init_params(key, cfg: Cfg) -> dict:
    """A parameter tree on the CPU from a threefry key, split and consumed
    in the reference's order."""
    n_layers, channels, l_max = cfg.n_layers, cfg.channels, cfg.l_max
    n_rbf, radial_hidden = cfg.n_rbf, cfg.radial_hidden
    n_species, d_feat, d_out = cfg.n_species, cfg.d_feat, cfg.d_out
    paths = tp_paths(l_max)
    ks = iter(threefry.split(key, n_layers * (4 + len(paths)) + 8))
    p = dict(layers=[])
    if d_feat:
        p["embed"] = _dense(next(ks), d_feat, channels)
    else:
        p["embed"] = dict(w=truncated_normal(next(ks), (n_species, channels),
                                             1.0))
    for _ in range(n_layers):
        layer = dict(
            radial1=_dense(next(ks), n_rbf, radial_hidden),
            radial2=_dense(next(ks), radial_hidden, len(paths) * channels),
            gates=_dense(next(ks), channels, channels * l_max),
            mix={}, self_mix={},
        )
        for l3 in range(l_max + 1):
            n_in = sum(1 for (a, b, c) in paths if c == l3)
            layer["mix"][str(l3)] = truncated_normal(
                next(ks), (n_in * channels, channels),
                1.0 / np.sqrt(max(1, n_in * channels)))
            layer["self_mix"][str(l3)] = truncated_normal(
                next(ks), (channels, channels), 1.0 / np.sqrt(channels))
        p["layers"].append(layer)
    p["head1"] = _dense(next(ks), channels, channels)
    p["head2"] = _dense(next(ks), channels, d_out)
    return p


def _init_feats(p, g: GraphBatch, l_max: int, channels: int):
    if g.node_feat is not None:
        scal = _apply(p["embed"], g.node_feat)
    else:
        scal = p["embed"]["w"][g.species.long()]
    n = g.positions.shape[0]
    feats = {0: scal[:, :, None]}
    for l in range(1, l_max + 1):
        feats[l] = scal.new_zeros((n, channels, 2 * l + 1))
    return feats


def forward(cfg: Cfg, p, g: GraphBatch):
    """→ (node_out [N, d_out], graph_out [n_graphs, d_out])."""
    l_max, n_rbf, cutoff = cfg.l_max, cfg.n_rbf, cfg.cutoff
    paths = tp_paths(l_max)
    channels = cfg.channels
    feats = _init_feats(p, g, l_max, channels)
    N = g.positions.shape[0]
    src_ids = g.edge_src.long()

    _, d, unit = edge_vectors(g)
    rbf = bessel_rbf(d, n_rbf, cutoff) * cosine_cutoff(d, cutoff)[:, None]
    sh = so3.real_sph_harm(l_max, unit)                       # [E, (L+1)²]
    sl = so3.l_slices(l_max)
    sh_l = {l: sh[:, a:b] for l, (a, b) in enumerate(sl)}
    ev = g.edge_valid.to(rbf.dtype)
    # the CG tables on the device once a forward, not once a layer
    cgs = [torch.as_tensor(so3.cg_real(*path), dtype=rbf.dtype,
                           device=rbf.device) for path in paths]

    for layer in p["layers"]:
        rad = F.silu(_apply(layer["radial1"], rbf))
        rad = _apply(layer["radial2"], rad).reshape(-1, len(paths), channels)
        # tensor-product messages per path, gathered at source
        agg = {l3: [] for l3 in range(l_max + 1)}
        for pi, (l1, l2, l3) in enumerate(paths):
            src = feats[l1][src_ids]                          # [E, C, 2l1+1]
            msg = torch.einsum("eci,ej,ijk->eck", src, sh_l[l2], cgs[pi])
            msg = msg * (rad[:, pi] * ev[:, None])[:, :, None]
            agg[l3].append(segment_mp(msg, g.edge_dst, N))
        # per-l linear mix over contributing paths + self connection
        new = {}
        for l3 in range(l_max + 1):
            stacked = torch.cat(agg[l3], 1)                   # [N, n_in·C, 2l3+1]
            mixed = torch.einsum("nim,ic->ncm", stacked, layer["mix"][str(l3)])
            self_c = torch.einsum("ncm,cd->ndm", feats[l3],
                                  layer["self_mix"][str(l3)])
            new[l3] = mixed + self_c
        # gated nonlinearity
        scal = new[0][:, :, 0]
        gates = torch.sigmoid(_apply(layer["gates"], scal))
        gates = gates.reshape(N, channels, l_max) if l_max else None
        out = {0: F.silu(scal)[:, :, None]}
        for l in range(1, l_max + 1):
            out[l] = new[l] * gates[:, :, l - 1][:, :, None]
        feats = out

    node = _apply(p["head2"], F.silu(_apply(p["head1"], feats[0][:, :, 0])))
    node = node * g.node_valid[:, None]
    graph = segment_sum(node, g.graph_id, g.n_graphs)
    return node, graph


class NequIP(ParamTree):
    """NequIP as a module: ``forward(g)`` → ``(node_out, graph_out)``;
    weights as :class:`~repro_torch.models.gnn.dimenet.DimeNet`'s."""

    def __init__(self, cfg: Cfg, params: dict | None = None, *, key=None,
                 device=None):
        super().__init__(init_params(threefry.prng_key(0) if key is None
                                     else key, cfg)
                         if params is None else params)
        self.cfg = cfg
        self.to(resolve_device(device))

    def forward(self, g: GraphBatch):
        return forward(self.cfg, self.tree(), g)
