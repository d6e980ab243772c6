"""Config dataclasses and input-shape cells of the port's architectures.

The twin of ``repro.configs.base``, for the families ported so far: the
LM transformers (``MoESpec``, ``LMConfig``, ``LM_SHAPES``), the GNNs
(``GNNConfig``, ``GNN_SHAPES``), the recsys model (``RecSysConfig``,
``RECSYS_SHAPES``), TriPoll's own workload (``TriPollConfig``) and the
``ShapeCell`` they use. One file per architecture lives next to this
module and exports ``CONFIG`` (the exact published shapes), ``SMOKE`` (a
reduced same-family variant for CPU tests), ``SHAPES`` (its input-shape
cells), ``KIND`` and, where the reference names one, ``OPTIMIZER``.
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


LM_SHAPES = (
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeCell(
        "long_500k", "decode", seq_len=524288, global_batch=1,
        skip_reason=(
            "pure full-attention arch: brief directs skip for long_500k "
            "(sub-quadratic attention required); decode lowering is O(L) "
            "per step and is recorded as an unscored extra"
        ),
    ),
)

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

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", global_batch=65536),
    ShapeCell("serve_p99", "serve", global_batch=512),
    ShapeCell("serve_bulk", "serve", global_batch=262144),
    ShapeCell("retrieval_cand", "retrieval", global_batch=1,
              extras=dict(n_candidates=1_000_000)),
)


# ---------------------------------------------------------------------------
# LM transformers


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    group_size: int = 2048       # tokens per dispatch group (memory knob)
    group_chunks: int = 1        # chunks over groups (memory knob)


@dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` less its sharding and compile knobs
    (``attn_shard``, ``moe_group_chunks``, ``scan_unroll``) and
    ``attn_bias``: one card has no mesh to shard over, and the port's
    models have no biases, as no published configuration does. ``remat``
    stays: under autograd each layer's forward is recomputed in its
    backward, as the reference's ``jax.checkpoint`` does, so a full-width
    step keeps one layer's activations rather than every layer's."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                       # 0 → d_model // n_heads
    moe: MoESpec | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"               # activation/compute dtype
    param_dtype: str = "bfloat16"
    attn_chunk: int = 1024                # flash-style KV block size
    remat: bool = True

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def n_params(self) -> int:
        """Total parameter count (embeddings + blocks), for roofline math."""
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        if self.moe is not None:
            ff = 3 * d * self.moe.d_ff_expert * self.moe.n_experts \
                + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        norms = 2 * d
        emb = 2 * self.vocab * d
        return self.n_layers * (attn + ff + norms) + emb + d

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        dense = self.n_params - self.n_layers * 3 * d * self.moe.d_ff_expert * self.moe.n_experts
        return dense + self.n_layers * 3 * d * self.moe.d_ff_expert * self.moe.top_k


# ---------------------------------------------------------------------------
# GNNs


@dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str                 # schnet | dimenet | nequip | equiformer_v2
    n_layers: int
    d_hidden: int
    extras: dict = field(default_factory=dict)
    dtype: str = "float32"


# ---------------------------------------------------------------------------
# RecSys


@dataclass(frozen=True)
class RecSysConfig:
    name: str
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple = (1024, 512, 256)
    n_items: int = 2_000_000            # sparse item-id table rows
    n_sparse_fields: int = 8            # side-feature fields
    vocab_per_field: int = 100_000
    dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# TriPoll (the paper's own workload as a dry-runnable arch)


@dataclass(frozen=True)
class TriPollConfig:
    name: str
    n_global: int
    n_loc: int
    e_cap: int                  # oriented edges per shard (padded)
    d_plus_max: int
    dvi: int = 0
    dvf: int = 0
    dei: int = 0
    def_: int = 0
    mode: str = "pushpull"
    push_cap: int = 2048
    n_push_steps: int = 64
    pull_q_cap: int = 64
    pull_edge_cap: int = 128
    n_pull_steps: int = 16
    unroll: bool = False        # kept for parity (the supersteps are loops)
