"""Distributed-optimization helpers: gradient compression with error
feedback.

The twin of ``repro.comm.collectives``. ``make_int8_compressor``
reproduces the numerics of an int8 compressed all-reduce (per-tensor
absmax scaling) with EF-SGD error feedback [Karimireddy et al. 2019]: the
quantization residual is carried to the next step, so compression bias
vanishes over time. ``torch.round`` rounds half to even, as ``jnp.round``
does, so the quantized bytes are the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def int8_quantize(x):
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale):
    return q.to(torch.float32) * scale


def make_int8_compressor():
    """Returns grad_transform(grads, ef) -> (grads', ef') for the trainer."""

    @torch.no_grad()
    def transform(grads, ef):
        new_g, new_e = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(ef)):
            g = g.to(torch.float32) + e
            q, s = int8_quantize(g)
            deq = int8_dequantize(q, s)
            new_g.append(deq)
            new_e.append(g - deq)
        return tree_unflatten(grads, new_g), tree_unflatten(grads, new_e)

    return transform


def compressed_bytes(tree) -> int:
    """Wire bytes for the int8 scheme (1 B/elem + 4 B scale per tensor)."""
    return sum(leaf.numel() + 4 for leaf in tree_leaves(tree))
