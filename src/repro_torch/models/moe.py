"""Mixture-of-Experts layer: top-k routing, capacity-based dense dispatch.

The twin of ``repro.models.moe``: the GShard/Switch dense dispatch form
(grouped tokens × one-hot dispatch tensors [G, gs, E, C]), deterministic
in shape. Top-k breaks ties toward the lower expert index, as
``lax.top_k`` does (a stable descending sort); a token's place in an
expert's queue is the running count of that expert's assignments in its
group, and assignments past the capacity ``C`` are dropped. The
reference's expert parallelism (experts over a mesh axis) has no
counterpart on one card; ``group_chunks`` splits the groups into chunks
computed one after another, as the reference's ``lax.map`` does.
:func:`route` makes the router's decisions (:class:`Routing`) and
:func:`moe_layer` calls it through the module, so a caller may wrap it to
read them. A sort-based dispatch is a later perf lever: the dense one
reads every expert's weights on every call, a decode step's too.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoESpec
from repro_torch.models import threefry
from repro_torch.models.layers import truncated_normal


def init_moe_params(key, d_model: int, spec: MoESpec, n_layers: int, dtype,
                    device=None):
    ks = threefry.split(key, 4)
    E, Fe = spec.n_experts, spec.d_ff_expert
    sc_in = 1.0 / np.sqrt(d_model)
    sc_out = 1.0 / np.sqrt(Fe)
    shape = (n_layers, E, d_model, Fe)
    return dict(
        router=truncated_normal(ks[0], (n_layers, d_model, E), sc_in,
                                torch.float32, device),
        wg=truncated_normal(ks[1], shape, sc_in, dtype, device),
        wu=truncated_normal(ks[2], shape, sc_in, dtype, device),
        wd=truncated_normal(ks[3], (n_layers, E, Fe, d_model), sc_out, dtype,
                            device),
    )


def _capacity(gs: int, spec: MoESpec) -> int:
    c = int(np.ceil(gs * spec.top_k / spec.n_experts * spec.capacity_factor))
    return max(4, int(np.ceil(c / 4)) * 4)


def _one_hot(idx, n: int):
    """``jax.nn.one_hot(idx, n, dtype=int32)``: all zeros where ``idx`` is
    out of [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int32)


def _einsum(eq, a, b):
    """``jnp.einsum`` of mixed dtypes: both operands in the promoted one."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _experts(p, xg, oh, pos, keep, gate, C: int):
    """Dispatch, the experts' SwiGLU and combine, for a chunk of groups."""
    dt = xg.dtype
    k = oh.shape[2]
    dis = comb = None
    for kk in range(k):
        d_k = (oh[:, :, kk, :, None] * _one_hot(pos[:, :, kk], C)[:, :, None, :]
               * keep[:, :, kk, None, None])
        g_k = d_k * gate[:, :, kk, None, None]
        dis = d_k if dis is None else dis + d_k
        comb = g_k if comb is None else comb + g_k
    dis, comb = dis.to(dt), comb.to(dt)
    xe = torch.einsum("gtec,gtd->gecd", dis, xg)
    h = _einsum("gecd,edf->gecf", xe, p["wg"])
    u = _einsum("gecd,edf->gecf", xe, p["wu"])
    h = F.silu(h) * u
    ye = _einsum("gecf,efd->gecd", h, p["wd"])
    y = torch.einsum("gtec,gecd->gtd", comb.float(), ye.float())
    return y.to(dt)


class Routing(NamedTuple):
    """The router's decisions for groups of tokens [G, gs, ...]."""

    logits: torch.Tensor      # [G, gs, E] float32
    probs: torch.Tensor       # [G, gs, E] float32, their softmax
    gate: torch.Tensor        # [G, gs, k] float32, renormalised over k
    eidx: torch.Tensor        # [G, gs, k] int64, the chosen experts
    oh: torch.Tensor          # [G, gs, k, E] int32, their one-hots
    pos: torch.Tensor         # [G, gs, k] int32, places in the queues
    keep: torch.Tensor        # [G, gs, k] bool, within the capacity


def route(xg, router, spec: MoESpec, C: int) -> Routing:
    """Top-k routing of ``xg`` [G, gs, D] with capacity ``C``."""
    G, gs, _ = xg.shape
    E, k = spec.n_experts, spec.top_k
    # the router in mixed precision: the router cast to the activations'
    # dtype, the products accumulated in float32
    logits = torch.einsum("gtd,de->gte", xg.float(), router.to(xg.dtype).float())
    probs = torch.softmax(logits, -1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]                 # [G,gs,k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # position of each (token, k) within its expert queue
    oh = _one_hot(eidx, E)                                    # [G,gs,k,E]
    flat = oh.reshape(G, gs * k, E)
    pos = torch.cumsum(flat, 1, dtype=torch.int32) * flat - 1
    pos = pos.reshape(G, gs, k, E).amax(-1)                   # [G,gs,k]
    keep = (pos >= 0) & (pos < C)
    return Routing(logits, probs, gate, eidx, oh, pos, keep)


def moe_layer(x, p, spec: MoESpec):
    """x [T, D] → (y [T, D], aux losses dict). T % group_size == 0."""
    T, D = x.shape
    gs = min(spec.group_size, T)
    G = T // gs
    E = spec.n_experts
    C = _capacity(gs, spec)
    xg = x.reshape(G, gs, D)
    logits, probs, gate, _, oh, pos, keep = route(xg, p["router"], spec, C)

    nchunk = min(spec.group_chunks or 1, G)
    if nchunk > 1 and G % nchunk == 0:
        n = G // nchunk
        y = torch.cat([_experts(p, xg[i:i + n], oh[i:i + n], pos[i:i + n],
                                keep[i:i + n], gate[i:i + n], C)
                       for i in range(0, G, n)])
    else:
        y = _experts(p, xg, oh, pos, keep, gate, C)

    # aux losses (Switch §4): load balance + router z-loss
    me = probs.mean((0, 1))                                   # [E]
    ce = oh.sum(2).float().mean((0, 1))                       # assignment frac
    aux = dict(
        load_balance=E * torch.sum(me * ce) * spec.aux_loss,
        router_z=torch.mean(torch.logsumexp(logits, -1) ** 2) * spec.router_z_loss,
    )
    return y.reshape(T, D), aux
