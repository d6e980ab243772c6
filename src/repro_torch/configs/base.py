"""Config dataclasses and input-shape cells of the port's architectures.

The twin of ``repro.configs.base``, for the families ported so far: the
GNNs (``GNNConfig``, ``GNN_SHAPES``) and the ``ShapeCell`` they use. One
file per ported architecture lives next to this module and exports
``CONFIG`` (the exact published shapes), ``SMOKE`` (a reduced same-family
variant for CPU tests), ``SHAPES`` (its input-shape cells) and ``KIND``.
The LM, recsys and TriPoll dry-run configs come with their slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape × step-kind) cell of the dry-run matrix."""

    name: str
    kind: str                 # train | prefill | decode | serve | retrieval | graph
    seq_len: int = 0
    global_batch: int = 0
    extras: dict = field(default_factory=dict)
    skip_reason: str | None = None   # e.g. long_500k on pure full-attention archs


GNN_SHAPES = (
    ShapeCell("full_graph_sm", "graph", extras=dict(
        n_nodes=2708, n_edges=10556, d_feat=1433, regime="full-batch")),
    ShapeCell("minibatch_lg", "graph", extras=dict(
        n_nodes=232965, n_edges=114615892, batch_nodes=1024,
        fanout=(15, 10), regime="sampled-training")),
    ShapeCell("ogb_products", "graph", extras=dict(
        n_nodes=2449029, n_edges=61859140, d_feat=100, regime="full-batch-large")),
    ShapeCell("molecule", "graph", extras=dict(
        n_nodes=30, n_edges=64, batch=128, regime="batched-small-graphs")),
)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str                 # schnet | dimenet | nequip | equiformer_v2
    n_layers: int
    d_hidden: int
    extras: dict = field(default_factory=dict)
    dtype: str = "float32"
