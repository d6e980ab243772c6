"""GNN and recsys cells and LM model FLOPs: the GNN, recsys and LM parts
of ``repro.launch.steps``.

A cell is one (architecture × input shape) pair: the model config the
cell builds (:func:`gnn_forward_builder`), its padded sizes
(``GNN_CELL_DIMS``, :func:`edge_pad`, :func:`triplet_cap`), the model
FLOPs of one forward (:func:`gnn_flops`; a train step is three times
that) and the training loss (:func:`gnn_loss`: node cross-entropy over
the valid nodes, or the graph-energy MSE). :func:`gnn_cell` puts them
together for a port ``make_train_step``. :func:`recsys_cell` is a BST
cell: its step (an AdamW train step, a forward, or retrieval scores),
the shapes and dtypes of its batch, and its model FLOPs
(:func:`recsys_flops`). The reference's cells also carry shardings and
abstract inputs for a JAX mesh (``CellPlan``); on one card the port has
no counterpart. Of the LM cells the port has the model FLOPs
(:func:`lm_attn_flops`, :func:`lm_train_flops`,
:func:`lm_prefill_flops`, :func:`lm_decode_flops`), for the card's model
TFLOP/s, and a train cell's optimizer (:func:`pick_opt`); the TriPoll
cells wait for the dry-run slice.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from repro_torch import configs as config_registry
from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.train.optimizer import Optimizer, adafactor, adamw

# ---------------------------------------------------------------------------
# LM cells: model FLOPs


def lm_attn_flops(cfg: LMConfig, B, S):
    """Attention score and value FLOPs of a causal forward over [B, S]."""
    return cfg.n_layers * B * cfg.n_heads * cfg.d_head * S * S * 2.0


def lm_train_flops(cfg: LMConfig, B, S):
    """One train step over [B, S] positions: forward and backward."""
    return 6.0 * cfg.n_active_params * B * S + 3.0 * lm_attn_flops(cfg, B, S)


def lm_prefill_flops(cfg: LMConfig, B, S):
    return 2.0 * cfg.n_active_params * B * S + lm_attn_flops(cfg, B, S)


def lm_decode_flops(cfg: LMConfig, B, S):
    """One decode step of B tokens against an S-entry cache."""
    return (2.0 * cfg.n_active_params * B
            + cfg.n_layers * B * cfg.n_heads * cfg.d_head * S * 4.0)


def pick_opt(mod):
    """A train cell's optimizer: Adafactor where the config module names
    it (``OPTIMIZER``), else AdamW."""
    if getattr(mod, "OPTIMIZER", "adamw") == "adafactor":
        return adafactor(1e-2)
    return adamw(3e-4)


# ---------------------------------------------------------------------------
# GNN cells

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


# ---------------------------------------------------------------------------
# recsys cells

RECSYS_BAG = 4            # ids a side-feature bag (the reference's cells)


def recsys_flops(cfg: RecSysConfig) -> int:
    """Model FLOPs of one sample's forward: the ranking MLP and the
    transformer blocks (the reference's ``mlp_flops + attn_flops``)."""
    d = cfg.embed_dim
    dims = ((cfg.seq_len + 1) * d + cfg.n_sparse_fields * d,) \
        + tuple(cfg.mlp_dims) + (1,)
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    attn = cfg.n_blocks * (cfg.seq_len + 1) ** 2 * d * 4 \
        + cfg.n_blocks * 8 * d * d * (cfg.seq_len + 1)
    return mlp + attn


@dataclass(frozen=True)
class RecSysCell:
    arch: str
    shape: str
    kind: str             # train | serve | retrieval
    cfg: RecSysConfig
    batch: int            # samples a step (1 for retrieval)
    inputs: dict          # the step's batch: name -> (shape, torch dtype)
    fn: object            # train: (state, batch); else (params, batch)
    opt: Optimizer | None  # the train step's optimizer
    model_flops: float


def recsys_cell(arch: str, shape: str, widths: str = "CONFIG") -> RecSysCell:
    """The cell of recsys ``arch`` at ``shape`` (the ``name`` of one of its
    ``SHAPES``), at the widths of the config module's ``CONFIG`` (or
    ``SMOKE``): a train step of AdamW(1e-3) over ``loss_fn``, a forward, or
    one history's retrieval scores over ``n_candidates`` padded up to a
    multiple of 512, as the reference's ``_recsys_cell`` builds them."""
    from repro_torch.models.recsys import bst
    from repro_torch.train.trainer import make_train_step

    mod = config_registry.get_arch(arch)
    cfg: RecSysConfig = getattr(mod, widths)
    cell = next(c for c in mod.SHAPES if c.name == shape)
    B, S, F = cell.global_batch, cfg.seq_len, cfg.n_sparse_fields
    i32, b8 = torch.int32, torch.bool
    flops = recsys_flops(cfg)
    if cell.kind in ("train", "serve"):
        inputs = dict(hist=((B, S), i32), target=((B,), i32),
                      fields=((B, F, RECSYS_BAG), i32),
                      field_valid=((B, F, RECSYS_BAG), b8))
        if cell.kind == "serve":
            return RecSysCell(arch, shape, "serve", cfg, B, inputs,
                              lambda p, b: bst.forward(cfg, p, b), None,
                              float(B * flops))
        inputs["label"] = ((B,), b8)
        opt = adamw(1e-3)
        fn = make_train_step(lambda p, b: bst.loss_fn(cfg, p, b), opt)
        return RecSysCell(arch, shape, "train", cfg, B, inputs, fn, opt,
                          3.0 * B * flops)
    n_cand = _pad_up(cell.extras["n_candidates"], 512)
    inputs = dict(hist=((1, S), i32), cand_ids=((n_cand,), i32))
    return RecSysCell(arch, shape, "retrieval", cfg, 1, inputs,
                      lambda p, b: bst.retrieval_scores(cfg, p, b), None,
                      2.0 * n_cand * cfg.embed_dim)
