"""SchNet [arXiv:1706.08566]: continuous-filter convolutions.

The twin of ``repro.models.gnn.schnet``. Brief config: n_interactions=3,
d_hidden=64, rbf=300, cutoff=10. Node inputs: species embedding
(molecular) or linear projection of ``node_feat`` (citation-style
shapes).

Parameters are a tree of the reference's layout — ``embed``, ``blocks``
(a list of ``filt1``, ``filt2``, ``w_in``, ``w_out1``, ``w_out2``),
``head1``, ``head2``, each a dict of ``w`` [din, dout] and ``b`` [dout]
(the species embedding: ``w`` alone). :func:`forward` takes such a tree,
as the reference's does, so a trainer can differentiate it; the module
:class:`SchNet` holds one as parameters named after the tree's paths
(``blocks.0.filt1.w``, ...). Matrix products are ``torch.matmul``;
the readout's ``jax.ops.segment_sum`` is ``index_add``. There is no
``rules`` argument: the reference's sharding constraints have no
counterpart on one card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.models import threefry
from repro_torch.models.gnn.common import (
    GraphBatch,
    cosine_cutoff,
    edge_vectors,
    gaussian_rbf,
    segment_mp,
    segment_sum,
    shifted_softplus,
)
from repro_torch.models.layers import truncated_normal
from repro_torch.utils import resolve_device

BLOCK_LAYERS = ("filt1", "filt2", "w_in", "w_out1", "w_out2")


@dataclass(frozen=True)
class Cfg:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 32
    d_feat: int = 0
    d_out: int = 1


def _dense(key, din, dout):
    return dict(w=truncated_normal(key, (din, dout), 1.0 / np.sqrt(din)),
                b=torch.zeros(dout, dtype=torch.float32))


def _apply(p, x):
    return x @ p["w"] + p["b"]


def init_params(key, cfg: Cfg) -> dict:
    """A parameter tree on the CPU, drawn from a
    :mod:`~repro_torch.models.threefry` key split as the reference splits
    its ``jax.random`` key: the reference's weights, within float32
    rounding."""
    n_interactions, d_hidden, n_rbf = cfg.n_interactions, cfg.d_hidden, cfg.n_rbf
    n_species, d_feat, d_out = cfg.n_species, cfg.d_feat, cfg.d_out
    ks = iter(threefry.split(key, 6 * n_interactions + 6))
    p = dict(blocks=[])
    if d_feat:
        p["embed"] = _dense(next(ks), d_feat, d_hidden)
    else:
        p["embed"] = dict(w=truncated_normal(next(ks), (n_species, d_hidden),
                                             1.0))
    for _ in range(n_interactions):
        p["blocks"].append({name: _dense(next(ks), *shape) for name, shape in zip(
            BLOCK_LAYERS, ((n_rbf, d_hidden),) + ((d_hidden, d_hidden),) * 4)})
    p["head1"] = _dense(next(ks), d_hidden, d_hidden // 2)
    p["head2"] = _dense(next(ks), d_hidden // 2, d_out)
    return p


def forward(cfg: Cfg, p, g: GraphBatch):
    """→ (node_out [N, d_out], graph_out [n_graphs, d_out])."""
    if g.node_feat is not None:
        h = _apply(p["embed"], g.node_feat)
    else:
        h = p["embed"]["w"][g.species.long()]
    _, d, _ = edge_vectors(g)
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)
    env = cosine_cutoff(d, cfg.cutoff)

    src = g.edge_src.long()
    for blk in p["blocks"]:
        w = _apply(blk["filt2"], shifted_softplus(_apply(blk["filt1"], rbf)))
        msg = _apply(blk["w_in"], h)[src] * w * env[:, None]
        agg = segment_mp(msg, g.edge_dst, h.shape[0], g.edge_valid)
        v = _apply(blk["w_out2"], shifted_softplus(_apply(blk["w_out1"], agg)))
        h = h + v

    node = _apply(p["head2"], shifted_softplus(_apply(p["head1"], h)))
    node = node * g.node_valid[:, None]
    graph = segment_sum(node, g.graph_id, g.n_graphs)
    return node, graph


class _Leaf(nn.Module):
    """One layer of the tree: its ``w`` (and ``b``) as parameters."""

    def __init__(self, leaves: dict):
        super().__init__()
        for k, v in leaves.items():
            self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        return dict(self.named_parameters(recurse=False))


class SchNet(nn.Module):
    """SchNet as a module: ``forward(g)`` → ``(node_out, graph_out)``.

    ``params`` is a tree from :func:`init_params` (or carried from the
    JAX package, see :func:`repro_torch.interop.schnet_params_from_jax`);
    without one, the weights are drawn from the threefry ``key`` (default
    ``threefry.prng_key(0)``, the reference's ``PRNGKey(0)``). They are
    placed on ``device`` (``None`` = the card)."""

    def __init__(self, cfg: Cfg, params: dict | None = None, *, key=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(threefry.prng_key(0) if key is None
                                 else key, cfg)
        self.embed = _Leaf(params["embed"])
        self.blocks = nn.ModuleList(
            nn.ModuleDict({k: _Leaf(blk[k]) for k in BLOCK_LAYERS})
            for blk in params["blocks"])
        self.head1 = _Leaf(params["head1"])
        self.head2 = _Leaf(params["head2"])
        self.to(resolve_device(device))

    def tree(self) -> dict:
        """The parameters as the reference's tree (the tensors
        themselves, not copies)."""
        return dict(embed=self.embed.tree(),
                    blocks=[{k: blk[k].tree() for k in BLOCK_LAYERS}
                            for blk in self.blocks],
                    head1=self.head1.tree(), head2=self.head2.tree())

    def forward(self, g: GraphBatch):
        return forward(self.cfg, self.tree(), g)
