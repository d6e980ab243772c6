"""Generic train step: gradient accumulation and compression.

The twin of ``repro.train.trainer``. ``make_train_step`` builds a
``(state, batch) -> (state, metrics)`` from any ``loss_fn(params, batch)
-> (loss, metrics)`` over a parameter tree. Gradients come from
``torch.autograd``; with ``accum_steps > 1`` the microbatches (the
leading axis of every tensor in ``batch``) are visited in order and their
gradients summed in float32 from zeros, then divided by ``accum_steps``,
as the reference's ``lax.scan`` does. Gradients can pass through an
optional transform — e.g. int8 quantize/dequantize with error feedback
(``comm.collectives.make_int8_compressor``). The reference's ``donate``
(buffer donation under ``jax.jit``) has no counterpart: the step is
eager and returns new tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.train.optimizer import (Optimizer, global_norm, tree_leaves,
                                         tree_map, tree_unflatten)


@dataclass(frozen=True)
class TrainState:
    params: dict
    opt_state: dict
    step: torch.Tensor
    ef: dict | None = None          # error-feedback residuals (compression)


def init_state(params, opt: Optimizer, compression: bool = False) -> TrainState:
    ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params) \
        if compression else None
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return TrainState(params=params, opt_state=opt.init(params), step=step,
                      ef=ef)


def _microbatch(batch, i: int):
    """Slice ``i`` of the leading axis of every tensor in ``batch`` (a
    tensor, a dict/list/tuple, or a dataclass such as ``GraphBatch``
    whose non-tensor fields are static)."""
    if isinstance(batch, torch.Tensor):
        return batch[i]
    if isinstance(batch, dict):
        return {k: _microbatch(v, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_microbatch(v, i) for v in batch)
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: _microbatch(getattr(batch, f.name), i)
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)})
    return batch


def _value_and_grad(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
    # a leaf the loss does not reach (NequIP's last l > 0 mixes) gets a
    # zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(loss_fn, opt: Optimizer, *, accum_steps: int = 1,
                    grad_transform=None):
    """loss_fn(params, batch) -> (loss, metrics). batch leading axis is the
    microbatch axis when accum_steps > 1: [accum, ...]."""

    def step(state: TrainState, batch):
        if accum_steps == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(state.params)[0].device)
            for i in range(accum_steps):
                l, _, g = _value_and_grad(loss_fn, state.params,
                                          _microbatch(batch, i))
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {}

        ef = state.ef
        if grad_transform is not None:
            grads, ef = grad_transform(grads, ef)

        new_params, new_opt = opt.update(grads, state.opt_state, state.params)
        metrics = dict(metrics or {}, loss=loss, grad_norm=global_norm(grads))
        return TrainState(params=new_params, opt_state=new_opt,
                          step=state.step + 1, ef=ef), metrics

    return step
