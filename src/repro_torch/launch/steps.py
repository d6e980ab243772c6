"""Per-(arch × shape) cell plans on one card: the function to trace or
run, its arguments and its model FLOPs — the twin of
``repro.launch.steps``.

:func:`build_cell` builds the reference's cell for one architecture and
input shape as a :class:`CellPlan`: ``fn(*args)`` is the cell's step (a
train step, a forward, a decode step, retrieval scores or a survey), and
``args`` are its inputs. They are allocation-free by default: built on
the meta device, every random draw skipped (``models.threefry`` and
``truncated_normal`` draw nothing there), so the 1 T-parameter configs
cost nothing; on a real device they are zeros and seeded draws are left
to the caller. :func:`all_cells` lists the reference's 43 cells in its
order. ``launch/dryrun.py`` traces each cell once under the op counter
(:mod:`repro_torch.roofline.count`).

The parts the cells are built from: the GNN cells (:func:`gnn_cell`:
the model config, padded sizes ``GNN_CELL_DIMS`` / :func:`edge_pad` /
:func:`triplet_cap`, the model FLOPs :func:`gnn_flops`, a train step
being three times a forward's, and the loss :func:`gnn_loss`), the
recsys cells (:func:`recsys_cell`: a BST step, its batch's shapes and
dtypes, :func:`recsys_flops`), the LM model FLOPs
(:func:`lm_attn_flops`, :func:`lm_train_flops`, :func:`lm_prefill_flops`,
:func:`lm_decode_flops`) and a train cell's optimizer
(:func:`pick_opt`). The TriPoll cells run the survey engine on a
:func:`~repro_torch.core.dodgr.dodgr_spec` graph at a mesh of the one
card: S = 1, as the reference computes its cell at a one-device mesh.
The reference's cells also carry shardings for a JAX mesh; one card has
none, so :class:`CellPlan` has no ``in_shardings``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch.configs.base import (GNNConfig, LMConfig, RecSysConfig,
                                      ShapeCell, TriPollConfig)
from repro_torch.train.optimizer import Optimizer, adafactor, adamw


@dataclass
class CellPlan:
    arch: str
    shape: str
    fn: object
    args: tuple
    donate: tuple = ()
    model_flops: float = 0.0
    note: str = ""
    skip_reason: str | None = None

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


def gnn_cell(arch: str, shape: str, widths: str = "CONFIG",
             cfg: GNNConfig | None = None) -> GNNCell:
    """The cell of GNN ``arch`` (a :func:`repro_torch.configs.get_arch`
    id) at ``shape`` (a key of ``GNN_CELL_DIMS``), at the widths of the
    config module's ``CONFIG`` (or ``SMOKE``, for a rehearsal), or of
    ``cfg``."""
    if cfg is None:
        cfg = getattr(config_registry.get_arch(arch), widths)
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


def recsys_cell(arch: str, shape: str, widths: str = "CONFIG",
                cfg: RecSysConfig | None = None) -> RecSysCell:
    """The cell of recsys ``arch`` at ``shape`` (the ``name`` of one of its
    ``SHAPES``), at the widths of the config module's ``CONFIG`` (or
    ``SMOKE``, or of ``cfg``): a train step of AdamW(1e-3) over ``loss_fn``, a forward, or
    one history's retrieval scores over ``n_candidates`` padded up to a
    multiple of 512, as the reference's ``_recsys_cell`` builds them."""
    from repro_torch.models.recsys import bst
    from repro_torch.train.trainer import make_train_step

    mod = config_registry.get_arch(arch)
    if cfg is None:
        cfg = getattr(mod, widths)
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


# ---------------------------------------------------------------------------
# cell plans


def map_tensors(fn, tree):
    """``tree`` (tensors in dicts, lists, tuples and dataclasses such as
    ``TrainState``, ``GraphBatch`` and ``ShardedDODGr``) with ``fn``
    applied to every tensor; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def tensor_leaves(tree) -> list:
    """Every tensor of ``tree`` (see :func:`map_tensors`), in its order."""
    out = []
    map_tensors(out.append, tree)
    return out


def _no_grad(fn):
    """``fn`` run without autograd: a serving cell's step."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _train_state(params, opt: Optimizer, device):
    from repro_torch.train.trainer import TrainState

    return TrainState(params=params, opt_state=opt.init(params),
                      step=_zeros((), torch.int32, device), ef=None)


def _lm_cell(arch, mod, shape: ShapeCell, device) -> CellPlan:
    from repro_torch.models import threefry
    from repro_torch.models import transformer as TF
    from repro_torch.train.trainer import make_train_step

    cfg: LMConfig = mod.CONFIG
    B, S = shape.global_batch, shape.seq_len
    params = TF.init_params(cfg, threefry.prng_key(0), device=device)
    i32 = torch.int32
    if shape.kind == "train":
        opt = pick_opt(mod)
        fn = make_train_step(lambda p, b: TF.loss_fn(cfg, p, b), opt)
        return CellPlan(arch, shape.name, fn,
                        (_train_state(params, opt, device),
                         _zeros((B, S + 1), i32, device)),
                        donate=(0,), model_flops=lm_train_flops(cfg, B, S),
                        note=f"opt={getattr(mod, 'OPTIMIZER', 'adamw')}")
    if shape.kind == "prefill":
        fn = _no_grad(lambda p, t: TF.forward(cfg, p, t, return_cache=True))
        return CellPlan(arch, shape.name, fn,
                        (params, _zeros((B, S), i32, device)),
                        model_flops=lm_prefill_flops(cfg, B, S))
    # decode (decode_32k / long_500k): one token against an S-entry cache
    fn = _no_grad(lambda p, c, t: TF.decode_step(cfg, p, c, t))
    return CellPlan(arch, shape.name, fn,
                    (params, TF.init_cache(cfg, B, S, device=device),
                     _zeros((B, 1), i32, device)),
                    donate=(1,), model_flops=lm_decode_flops(cfg, B, S),
                    skip_reason=shape.skip_reason)


def _gnn_cell(arch, mod, shape: ShapeCell, device) -> CellPlan:
    from repro_torch.models import threefry
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train.trainer import make_train_step

    cell = gnn_cell(arch, shape.name, cfg=mod.CONFIG)
    dims, E, T = cell.dims, cell.e_pad, cell.t_cap
    N = dims["N"]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    with torch.device(device):        # the draws' and zeros' device
        params = cell.module.init_params(threefry.prng_key(0), cell.cfg)
    opt = adamw(1e-3)
    graph = GraphBatch(
        node_feat=(_zeros((N, dims["d_feat"]), f32, device)
                   if dims["d_feat"] else None),
        species=None if dims["d_feat"] else _zeros((N,), i32, device),
        positions=_zeros((N, 3), f32, device),
        edge_src=_zeros((E,), i32, device), edge_dst=_zeros((E,), i32, device),
        edge_valid=_zeros((E,), b8, device), node_valid=_zeros((N,), b8, device),
        graph_id=_zeros((N,), i32, device), n_graphs=dims["n_graphs"])
    labels = (_zeros((N,), i32, device) if dims["task"] == "node"
              else _zeros((dims["n_graphs"],), f32, device))
    batch = dict(graph=graph, labels=labels)
    if cell.family == "dimenet":
        batch.update(t_in=_zeros((T,), i32, device),
                     t_out=_zeros((T,), i32, device),
                     t_valid=_zeros((T,), b8, device))
    return CellPlan(arch, shape.name, make_train_step(cell.loss_fn, opt),
                    (_train_state(params, opt, device), batch), donate=(0,),
                    model_flops=cell.model_flops,
                    note=f"{dims['task']} E={dims['E']} t_cap={T}")


def _recsys_cell(arch, mod, shape: ShapeCell, device) -> CellPlan:
    from repro_torch.models import threefry
    from repro_torch.models.recsys import bst

    cell = recsys_cell(arch, shape.name, cfg=mod.CONFIG)
    params = bst.init_params(cell.cfg, threefry.prng_key(0), device=device)
    batch = {k: _zeros(shp, dt, device) for k, (shp, dt) in cell.inputs.items()}
    if cell.kind == "train":
        return CellPlan(arch, shape.name, cell.fn,
                        (_train_state(params, cell.opt, device), batch),
                        donate=(0,), model_flops=cell.model_flops)
    return CellPlan(arch, shape.name, _no_grad(cell.fn), (params, batch),
                    model_flops=cell.model_flops)


def _tripoll_cell(arch, mod, shape: ShapeCell, device) -> CellPlan:
    """The survey of the reference's ``_tripoll_cell`` at a mesh of the
    one card: S = 1, so one shard holds the whole graph (``n_loc =
    n_global``, ``e_cap`` = 256 of CONFIG's shards) and the caps and
    superstep counts are CONFIG's."""
    from repro_torch.core.dodgr import dodgr_spec
    from repro_torch.core.engine import EngineConfig, make_survey_fn
    from repro_torch.core.surveys import (ClosureTime, SurveyBundle,
                                          TopKWeightedTriangles,
                                          TriangleCount)

    cfg: TriPollConfig = mod.CONFIG
    S = 1
    n_loc = -(-cfg.n_global // S)
    e_cap = cfg.e_cap * 256 // S
    mode = shape.extras["mode"]
    ecfg = EngineConfig(
        mode=mode, push_cap=max(256, cfg.push_cap),
        n_push_steps=cfg.n_push_steps, pull_q_cap=max(1, cfg.pull_q_cap),
        pull_edge_cap=max(4, cfg.pull_edge_cap),
        n_pull_steps=cfg.n_pull_steps if mode == "pushpull" else 0,
        unroll_steps=cfg.unroll)
    gr = dodgr_spec(S=S, n_global=cfg.n_global, n_loc=n_loc, e_cap=e_cap,
                    d_plus_max=cfg.d_plus_max, dvi=cfg.dvi, dvf=cfg.dvf,
                    dei=cfg.dei, def_=cfg.def_, device=device)
    if shape.extras.get("bundle"):
        survey = SurveyBundle([TriangleCount(), ClosureTime(),
                               ClosureTime(n_buckets=32),
                               TopKWeightedTriangles(k=128)])
    else:
        survey = ClosureTime()
    # useful work: one keyed binary search per wedge (≈ log2(L) × 8 ops)
    wedges = S * S * cfg.push_cap * (cfg.n_push_steps + cfg.n_pull_steps)
    flops = wedges * np.log2(max(2, cfg.d_plus_max)) * 8.0
    return CellPlan(arch, shape.name, make_survey_fn(survey, ecfg), (gr,),
                    model_flops=flops,
                    note=f"S={S} e_cap={e_cap} mode={mode}")


class _ModProxy:
    """Config-module proxy with an overridden CONFIG."""

    def __init__(self, mod, cfg):
        self._mod = mod
        self.CONFIG = cfg

    def __getattr__(self, name):
        return getattr(self._mod, name)


_CELLS = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
          "tripoll": _tripoll_cell}


def build_cell(arch_id: str, shape_name: str, overrides: dict | None = None,
               device="meta") -> CellPlan:
    """The cell of ``arch_id`` at ``shape_name``, its arguments on
    ``device`` (the meta device: nothing allocated). ``overrides``:
    dataclass field replacements applied to CONFIG (a reduced depth, one
    shard of a deployment)."""
    mod = config_registry.get_arch(arch_id)
    if overrides:
        mod = _ModProxy(mod, replace(mod.CONFIG, **overrides))
    shape = next(s for s in mod.SHAPES if s.name == shape_name)
    if mod.KIND not in _CELLS:
        raise KeyError(mod.KIND)
    return _CELLS[mod.KIND](arch_id, mod, shape, torch.device(device))


def all_cells(include_tripoll=True):
    """Every (arch, shape) pair of the registry, in the reference's order."""
    out = []
    for arch in config_registry.list_archs():
        mod = config_registry.get_arch(arch)
        if mod.KIND == "tripoll" and not include_tripoll:
            continue
        for s in mod.SHAPES:
            out.append((arch, s.name))
    return out
