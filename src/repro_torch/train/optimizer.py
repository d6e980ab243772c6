"""Optimizers as (init, update) pairs over parameter trees.

The twin of ``repro.train.optimizer``. A tree is a tensor or nested dicts,
lists and tuples of tensors; leaves are visited in the reference's pytree
order (dict keys sorted). Every update does the reference's arithmetic in
the reference's order on float32 tensors under ``torch.no_grad()`` and
returns new trees, as the reference's functional updates do.
``torch.optim.AdamW`` is not a substitute: it adds epsilon and applies
decay in other places.

AdamW keeps f32 moments, clips by the global norm (1.0 by default) and
corrects the moments' bias in float32. Adafactor factors the second moment
(row/col vectors), its state a list aligned with the flattened
parameters. The reference's ``state_specs`` (PartitionSpecs for a JAX
mesh) has no counterpart on one card, so :class:`Optimizer` is a pair.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state)


# ---------------------------------------------------------------------------
# trees


def tree_leaves(tree) -> list:
    """Leaves in pytree order (dict keys sorted; ``None`` holds none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _build(t, it):
    if t is None:
        return None
    if isinstance(t, dict):
        out = {k: _build(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in pytree order.
    (A module-level recursion: a nested recursive function would form a
    reference cycle through its closure, and keep ``leaves`` alive until
    Python's cyclic collector ran.)"""
    return _build(like, iter(leaves))


def tree_map(fn, tree, *rest):
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


def _f32_zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: float | None = 1.0) -> Optimizer:
    def init(params):
        return dict(step=_step0(params), m=tree_map(_f32_zeros, params),
                    v=tree_map(_f32_zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        if clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp_max(clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state["step"] + 1
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), m, v

        out = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (
            grads, state["m"], state["v"], params)))]
        new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                               for i in range(3))
        return new_p, dict(step=step, m=new_m, v=new_v)

    return Optimizer(init, update)


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern) with factored 2nd moment, no momentum."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        stats = []
        for p in tree_leaves(params):
            if _factored(p):
                stats.append(dict(
                    vr=torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device),
                    vc=torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device)))
            else:
                stats.append(dict(v=_f32_zeros(p)))
        return dict(step=_step0(params), stats=stats)

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)
        new_p, new_s = [], []
        for g, s, p in zip(tree_leaves(grads), state["stats"],
                           tree_leaves(params)):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp_min(vr.mean(-1)[..., None, None], eps))
                u = g * torch.rsqrt(torch.clamp_min(denom, eps))
                new_s.append(dict(vr=vr, vc=vc))
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, eps))
                new_s.append(dict(v=v))
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            u = u + weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * u).to(p.dtype))
        return tree_unflatten(params, new_p), dict(step=step, stats=new_s)

    return Optimizer(init, update)


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return dict(step=_step0(params), m=tree_map(_f32_zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        def upd(g, m, p):
            m = momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr * m).to(p.dtype), m

        out = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (
            grads, state["m"], params)))]
        return (tree_unflatten(params, [o[0] for o in out]),
                dict(step=state["step"] + 1,
                     m=tree_unflatten(params, [o[1] for o in out])))

    return Optimizer(init, update)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf after leaf in pytree
    order from 0.0 (the reference's ``jax.tree.reduce``)."""
    leaves = tree_leaves(tree)
    sq = torch.zeros((), dtype=torch.float32,
                     device=leaves[0].device if leaves else None)
    for x in leaves:
        sq = sq + torch.sum(x.to(torch.float32) ** 2)
    return torch.sqrt(sq)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * s / max(1, warmup)
        prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return lr
