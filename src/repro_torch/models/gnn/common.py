"""Shared GNN substrate: graph batches, segment message passing, bases.

The twin of ``repro.models.gnn.common``. Message passing is edge index →
gather → ``index_add`` into zeros, as the reference's is gather →
``jax.ops.segment_sum``: plain PyTorch, because the reference computes it
outside any Pallas kernel. Float functions follow the reference's
operations in its order (the Gaussian centres as XLA folds
``jnp.linspace``, ``lax.integer_pow``'s products, ``logaddexp``'s softplus), so
they agree with it within float32 rounding; :func:`build_triplets` is
host numpy and equal bit for bit.

The synthetic batches (:func:`random_graph_batch`,
:func:`radius_graph_batch`) draw from a ``torch.Generator`` where the
reference draws from ``jax.random``: they match it in shapes, dtypes and
value ranges, not in bits. The host parts of :func:`radius_graph_batch`
(the edge subsample and the species) are the reference's own numpy
draws.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class GraphBatch:
    """Padded static-shape (batched) graph."""

    node_feat: torch.Tensor | None    # [N, F] float or None
    species: torch.Tensor | None      # [N] int32 or None
    positions: torch.Tensor           # [N, 3] f32
    edge_src: torch.Tensor            # [E] int32
    edge_dst: torch.Tensor            # [E] int32
    edge_valid: torch.Tensor          # [E] bool
    node_valid: torch.Tensor          # [N] bool
    graph_id: torch.Tensor            # [N] int32 (readout segments)
    n_graphs: int

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` added into zeros."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: the row-wise max per segment, −inf for a
    segment with no row (``scatter_reduce`` alone would keep its initial
    value)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), -torch.inf)
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_mp(messages, edge_dst, n_nodes, edge_valid=None):
    """Scatter-sum messages [E, ...] to destination nodes [N, ...]."""
    if edge_valid is not None:
        messages = messages * _bcast(edge_valid, messages)
    return segment_sum(messages, edge_dst, n_nodes)


def segment_softmax(scores, edge_dst, n_nodes, edge_valid=None):
    """Edge-softmax over incoming edges per destination node."""
    if edge_valid is not None:
        scores = torch.where(_bcast(edge_valid, scores), scores,
                             torch.tensor(-1e30, dtype=scores.dtype,
                                          device=scores.device))
    mx = segment_max(scores, edge_dst, n_nodes)
    ex = torch.exp(scores - mx[edge_dst.long()])
    if edge_valid is not None:
        ex = ex * _bcast(edge_valid, ex)
    den = segment_sum(ex, edge_dst, n_nodes)
    return ex / torch.clamp_min(den[edge_dst.long()], 1e-30)


def edge_vectors(g: GraphBatch):
    """Relative vectors, distances (clamped), unit directions."""
    vec = g.positions[g.edge_dst.long()] - g.positions[g.edge_src.long()]
    d = torch.sqrt((vec * vec).sum(-1))
    d_safe = torch.clamp_min(d, 1e-6)
    return vec, d, vec / d_safe[:, None]


def _centers(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` in float32 as XLA compiles it: the
    ``0·(1 − k/div)`` term folded away, the division by ``div`` a product
    with the float32 reciprocal, and the constants multiplied first —
    ``k × (stop × (1/div))`` — the last point ``stop`` itself."""
    f32 = torch.float32
    stop_t = torch.tensor([stop], dtype=f32, device=device)
    if num == 1:
        return torch.zeros(1, dtype=f32, device=device)
    div = num - 1
    inv = torch.tensor(1.0, dtype=f32) / torch.tensor(float(div), dtype=f32)
    step = (torch.tensor(stop, dtype=f32) * inv).to(device)
    return torch.cat([torch.arange(div, dtype=f32, device=device) * step,
                      stop_t])


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``lax.integer_pow``: binary exponentiation, its products in its
    order."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def gaussian_rbf(d, n_rbf: int, cutoff: float):
    """SchNet-style Gaussian radial basis on [0, cutoff]."""
    centers = _centers(cutoff, n_rbf, d.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * _integer_pow(d[:, None] - centers[None, :], 2))


def bessel_rbf(d, n_rbf: int, cutoff: float):
    """DimeNet/NequIP Bessel radial basis sqrt(2/c)·sin(nπd/c)/d."""
    d_safe = torch.clamp_min(d, 1e-6)[:, None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    return (float(np.sqrt(2.0 / cutoff))
            * torch.sin(n * np.pi * d_safe / cutoff) / d_safe)


def cosine_cutoff(d, cutoff: float):
    """Smooth envelope → 0 at the cutoff radius."""
    return torch.where(d < cutoff, 0.5 * (torch.cos(np.pi * d / cutoff) + 1.0),
                       0.0)


def polynomial_cutoff(d, cutoff: float, p: int = 6):
    """DimeNet envelope u(d) (Eq. 8)."""
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    return ((1.0 + a * _integer_pow(x, p) + b * _integer_pow(x, p + 1)
             + c * _integer_pow(x, p + 2)) * (x < 1.0))


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(−|x|)),
    its derivative exp(x − softplus(x)) as the reference's custom JVP
    gives it. Only ``x`` is kept for the backward pass."""

    @staticmethod
    def _value(x):
        return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _Softplus._value(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.exp(x - _Softplus._value(x))


def shifted_softplus(x):
    return _Softplus.apply(x) - float(np.log(2.0))


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int,
                   max_triplets: int | None = None):
    """Host-side triplet index lists for directional MP (DimeNet).

    For every pair of edges (k→j) and (j→i) with k != i, emit
    (edge_kj, edge_ji). Returns padded (t_in, t_out, valid).
    """
    E = len(edge_src)
    by_dst: dict[int, list[int]] = {}
    for e in range(E):
        by_dst.setdefault(int(edge_dst[e]), []).append(e)
    t_in, t_out = [], []
    for e_ji in range(E):
        j = int(edge_src[e_ji])
        i = int(edge_dst[e_ji])
        for e_kj in by_dst.get(j, ()):
            if int(edge_src[e_kj]) != i:
                t_in.append(e_kj)
                t_out.append(e_ji)
    n = len(t_in)
    cap = max_triplets or max(1, n)
    if n > cap:
        raise ValueError(f"triplet overflow: {n} > {cap}")
    ti = np.zeros(cap, np.int32)
    to = np.zeros(cap, np.int32)
    tv = np.zeros(cap, bool)
    ti[:n], to[:n], tv[:n] = t_in, t_out, True
    return ti, to, tv


# ---------------------------------------------------------------------------
# synthetic graph batches for smoke tests / benchmarks


def random_graph_batch(generator: torch.Generator, n_nodes: int, n_edges: int,
                       d_feat: int = 0, n_species: int = 0, n_graphs: int = 1,
                       box: float = 8.0, device=None) -> GraphBatch:
    """Uniform positions in a box, uniform random edges without self
    loops; drawn on the CPU from ``generator``, then placed on ``device``
    (``None`` = the card)."""
    dev = resolve_device(device)
    gen = dict(generator=generator)
    pos = torch.rand((n_nodes, 3), **gen) * box
    src = torch.randint(0, n_nodes, (n_edges,), **gen)
    dst = torch.randint(0, n_nodes, (n_edges,), **gen)
    dst = torch.where(dst == src, (dst + 1) % n_nodes, dst)
    gid = (torch.arange(n_nodes) * n_graphs) // n_nodes
    return GraphBatch(
        node_feat=(torch.randn((n_nodes, d_feat), **gen) if d_feat else None),
        species=(torch.randint(0, n_species, (n_nodes,), **gen)
                 .to(torch.int32) if n_species else None),
        positions=pos,
        edge_src=src.to(torch.int32),
        edge_dst=dst.to(torch.int32),
        edge_valid=torch.ones(n_edges, dtype=torch.bool),
        node_valid=torch.ones(n_nodes, dtype=torch.bool),
        graph_id=gid.to(torch.int32),
        n_graphs=n_graphs,
    ).to(dev)


def radius_graph_batch(generator: torch.Generator, n_nodes: int,
                       cutoff: float, box: float, e_cap: int,
                       n_graphs: int = 1, n_species: int = 8,
                       device=None) -> GraphBatch:
    """Positions in a box; edges = pairs within cutoff (host build,
    padded). Positions come from ``generator``; the rest is the
    reference's host code."""
    dev = resolve_device(device)
    pos = torch.rand((n_nodes, 3), generator=generator).numpy() * box
    diff = pos[:, None] - pos[None, :]
    d = np.sqrt((diff ** 2).sum(-1))
    src, dst = np.nonzero((d < cutoff) & (d > 0))
    if len(src) > e_cap:
        keep = np.random.default_rng(0).choice(len(src), e_cap, replace=False)
        src, dst = src[keep], dst[keep]
    n = len(src)
    pad = e_cap - n
    gid = (np.arange(n_nodes) * n_graphs) // n_nodes
    return GraphBatch(
        node_feat=None,
        species=torch.as_tensor(
            np.random.default_rng(1).integers(0, n_species, n_nodes),
            dtype=torch.int32),
        positions=torch.as_tensor(pos, dtype=torch.float32),
        edge_src=torch.as_tensor(np.pad(src, (0, pad)), dtype=torch.int32),
        edge_dst=torch.as_tensor(np.pad(dst, (0, pad)), dtype=torch.int32),
        edge_valid=torch.as_tensor(np.pad(np.ones(n, bool), (0, pad))),
        node_valid=torch.ones(n_nodes, dtype=torch.bool),
        graph_id=torch.as_tensor(gid, dtype=torch.int32),
        n_graphs=n_graphs,
    ).to(dev)
