"""GNN cells: the GNN part of ``repro.launch.steps``.

A cell is one (architecture × input shape) pair: the model config the
cell builds (:func:`gnn_forward_builder`), its padded sizes
(``GNN_CELL_DIMS``, :func:`edge_pad`, :func:`triplet_cap`), the model
FLOPs of one forward (:func:`gnn_flops`; a train step is three times
that) and the training loss (:func:`gnn_loss`: node cross-entropy over
the valid nodes, or the graph-energy MSE). :func:`gnn_cell` puts them
together for a port ``make_train_step``. The reference's cell also
carries shardings and abstract inputs for a JAX mesh (``CellPlan``); on
one card the port has no counterpart. The LM, recsys and TriPoll cells
wait for the dry-run slice.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from repro_torch import configs as config_registry
from repro_torch.configs.base import GNNConfig

# N is padded to a 512 multiple (shardable over both production meshes);
# the logical brief sizes live in `N_logical` and the padding rides the
# node_valid mask.
GNN_CELL_DIMS = {
    "full_graph_sm": dict(N=3072, N_logical=2708, E=10556, d_feat=1433,
                          d_out=8, task="node", n_graphs=1),
    "minibatch_lg": dict(N=1024 + 1024 * 15 + 1024 * 150,
                         N_logical=1024 + 1024 * 15 + 1024 * 150,
                         E=1024 * 15 + 1024 * 150,
                         d_feat=602, d_out=41, task="node", n_graphs=1),
    "ogb_products": dict(N=2449408, N_logical=2449029, E=61859140, d_feat=100,
                         d_out=47, task="node", n_graphs=1),
    "molecule": dict(N=4096, N_logical=30 * 128, E=64 * 128, d_feat=0,
                     d_out=1, task="energy", n_graphs=128),
}


def _pad_up(x, m):
    return -(-x // m) * m


def edge_pad(dims) -> int:
    """Edge slots of a cell: large edge sets pad to a chunkable+shardable
    multiple (64 chunks × 512)."""
    return _pad_up(dims["E"], 32768 if dims["E"] >= 1 << 20 else 4096)


def triplet_cap(family: str, dims) -> int:
    """DimeNet's triplet slots (4 a real edge, padded); 0 for the others."""
    return _pad_up(4 * dims["E"], 4096) if family == "dimenet" else 0


def gnn_forward_builder(family, cfg: GNNConfig, dims, e_pad):
    """→ (the model's module, its ``Cfg`` at ``cfg``'s widths for the
    cell)."""
    ex = dict(cfg.extras)
    kw = dict(d_feat=dims["d_feat"], d_out=dims["d_out"])
    if family not in ("schnet", "dimenet", "nequip", "equiformer_v2"):
        raise KeyError(family)
    m = importlib.import_module(f"repro_torch.models.gnn.{family}")
    if family == "schnet":
        mc = m.Cfg(n_interactions=cfg.n_layers, d_hidden=cfg.d_hidden,
                   n_rbf=ex["n_rbf"], cutoff=ex["cutoff"], **kw)
    elif family == "dimenet":
        mc = m.Cfg(n_blocks=cfg.n_layers, d_hidden=cfg.d_hidden,
                   n_bilinear=ex["n_bilinear"], n_spherical=ex["n_spherical"],
                   n_radial=ex["n_radial"], cutoff=ex["cutoff"], **kw)
    elif family == "nequip":
        mc = m.Cfg(n_layers=cfg.n_layers, channels=cfg.d_hidden,
                   l_max=ex["l_max"], n_rbf=ex["n_rbf"], cutoff=ex["cutoff"],
                   **kw)
    else:
        chunks = ex.get("edge_chunks", 64 if e_pad >= 1 << 22 else 1)
        mc = m.Cfg(n_layers=cfg.n_layers, channels=cfg.d_hidden,
                   l_max=ex["l_max"], m_max=ex["m_max"], n_heads=ex["n_heads"],
                   n_rbf=ex["n_rbf"], cutoff=ex["cutoff"],
                   edge_chunks=chunks, **kw)
    return m, mc


def gnn_flops(family, cfg: GNNConfig, dims, t_cap) -> float:
    """Model FLOPs of one forward over the cell (the reference's count)."""
    E, N, d = dims["E"], dims["N"], cfg.d_hidden
    if family == "schnet":
        per_edge = 2 * d * d + 2 * cfg.extras["n_rbf"] * d
        return cfg.n_layers * (E * per_edge + N * 4 * d * d) * 2.0
    if family == "dimenet":
        ex = cfg.extras
        sbf = ex["n_spherical"] * ex["n_radial"]
        per_tri = 2 * (sbf * ex["n_bilinear"] + d * ex["n_bilinear"]
                       + ex["n_bilinear"] * d)
        return cfg.n_layers * (t_cap * per_tri + E * 6 * d * d) * 1.0
    if family == "nequip":
        from repro_torch.models.gnn.nequip import tp_paths

        l_max = cfg.extras["l_max"]
        tp = sum((2 * a + 1) * (2 * b + 1) * (2 * c + 1)
                 for a, b, c in tp_paths(l_max))
        return cfg.n_layers * E * cfg.d_hidden * tp * 2.0
    if family == "equiformer_v2":
        l_max, m_max = cfg.extras["l_max"], cfg.extras["m_max"]
        rotf = sum((2 * l + 1) ** 2 for l in range(l_max + 1)) * d * 2 * 2
        so2 = sum((2 if m else 1) * ((l_max + 1 - m) * d) ** 2 * 2
                  for m in range(m_max + 1))
        return cfg.n_layers * E * (rotf + so2) * 1.0
    return 0.0


def gnn_loss(family, m, mc, task: str):
    """``loss_fn(params, batch) -> (loss, dict(nll=loss))`` over a batch
    ``dict(graph=GraphBatch, labels=...)`` (DimeNet's also ``t_in``,
    ``t_out``, ``t_valid``): node cross-entropy over the valid nodes
    (``task == "node"``, int labels [N]) or the graph-energy MSE (float
    labels [n_graphs])."""

    def loss_fn(params, batch):
        graph, labels = batch["graph"], batch["labels"]
        if family == "dimenet":
            tri = (batch["t_in"], batch["t_out"], batch["t_valid"])
            node, gout = m.forward(mc, params, graph, tri)
        else:
            node, gout = m.forward(mc, params, graph)
        if task == "node":
            lz = torch.logsumexp(node, -1)
            gold = torch.gather(node, -1, labels.long()[:, None])[:, 0]
            per = (lz - gold) * graph.node_valid
            loss = per.sum() / torch.clamp_min(graph.node_valid.sum(), 1)
        else:
            loss = torch.mean((gout[:, 0] - labels) ** 2)
        return loss, dict(nll=loss)

    return loss_fn


@dataclass(frozen=True)
class GNNCell:
    arch: str
    shape: str
    family: str
    module: object        # repro_torch.models.gnn.<family>
    cfg: object           # the module's Cfg
    dims: dict
    e_pad: int
    t_cap: int
    loss_fn: object
    model_flops: float    # one train step: 3 × the forward's


def gnn_cell(arch: str, shape: str, widths: str = "CONFIG") -> GNNCell:
    """The cell of GNN ``arch`` (a :func:`repro_torch.configs.get_arch`
    id) at ``shape`` (a key of ``GNN_CELL_DIMS``), at the widths of the
    config module's ``CONFIG`` (or ``SMOKE``, for a rehearsal)."""
    cfg: GNNConfig = getattr(config_registry.get_arch(arch), widths)
    dims = GNN_CELL_DIMS[shape]
    e_pad = edge_pad(dims)
    t_cap = triplet_cap(cfg.family, dims)
    m, mc = gnn_forward_builder(cfg.family, cfg, dims, e_pad)
    return GNNCell(arch, shape, cfg.family, m, mc, dims, e_pad, t_cap,
                   gnn_loss(cfg.family, m, mc, dims["task"]),
                   3.0 * gnn_flops(cfg.family, cfg, dims, t_cap))
