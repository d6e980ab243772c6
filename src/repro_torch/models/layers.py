"""Shared neural layers: norms, RoPE, chunked (flash-style) attention, the
initial weights, and the module that holds a parameter tree.

The twin of ``repro.models.layers``. :func:`truncated_normal` draws the
reference's initial weights; :class:`ParamTree` holds a parameter tree
of the reference's layout as a module. :func:`chunked_attention` streams
over blocks of the KV axis with running (max, denom, acc) statistics in
float32, in the reference's order of steps, so the [S, S] score matrix
is never built; a Python loop over the blocks stands in for
``lax.scan``. Products the reference asks in float32
(``preferred_element_type``) take float32 operands here: a bfloat16
product is exact in float32, so only the order of the sums differs. The
reference's ``ShardRules`` / ``NO_RULES`` are sharding constraints for a
JAX mesh; the port's models run on one card and have no counterpart, so
their ``forward`` takes no ``rules`` argument.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import threefry

NEG_INF = -1e30


def truncated_normal(key, shape, scale, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """``scale`` × a standard normal truncated to (-2, 2), drawn on
    ``device`` (``None``: torch's default device, the CPU unless a
    ``torch.device`` context names another) by
    :func:`~repro_torch.models.threefry.torch_truncated_normal`. On the
    meta device nothing is drawn.

    ``key`` is a key of :mod:`repro_torch.models.threefry`: the draw is
    ``repro.models.layers.truncated_normal``'s with the matching
    ``jax.random`` key, within float32 rounding. As in the reference, the
    scale is rounded to float32 before it multiplies the draw. The draw,
    the product and the cast to ``dtype`` are taken ``threefry._CHUNK``
    elements at a time, straight into the leaf: its peak is the leaf and
    one chunk's temporaries."""
    shape = tuple(int(s) for s in shape)
    return threefry.torch_truncated_normal(
        key, -2.0, 2.0, shape, device or torch.get_default_device(),
        scale=scale, dtype=dtype)


def rms_norm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(d_head: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(d_head: int, theta: float, device: torch.device):
    """:func:`rope_freqs` on ``device``, copied there once: a copy from
    host memory waits for the device's queue, which every layer of a
    decode step would otherwise do twice."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def apply_rope(x, pos, theta: float):
    """x [B, S, H, dh]; pos [B, S] int32 — LLaMA-style half rotation."""
    dh = x.shape[-1]
    inv = _rope_freqs_on(dh, theta, x.device)
    ang = pos.float()[..., None] * inv                      # [B,S,dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _scores(q, k, scale):
    """``einsum("bqhd,bchd->bqhc")`` accumulated in float32, times scale."""
    return torch.einsum("bqhd,bchd->bqhc", q.float(), k.float()) * scale


def chunked_attention(q, k, v, q_pos, kv_pos, kv_valid=None, chunk: int = 1024,
                      causal: bool = True):
    """Streaming softmax attention (GQA via repeat-KV).

    q [B,Sq,H,dh]; k,v [B,Skv,Hkv,dh]; q_pos [B,Sq]; kv_pos [B,Skv].
    Returns [B,Sq,H,dh]. Skv is padded to a chunk multiple where it is
    longer than one chunk. Three forms, chosen as the reference chooses:
    one block (``Skv <= chunk``; the output in ``v``'s dtype), streaming
    over whole chunks, and streaming after padding (the padded keys
    invalid); a wholly masked row scores ``NEG_INF`` everywhere, as in
    the reference, so it averages its values rather than giving NaN."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = float(1.0 / np.sqrt(dh))

    if Skv > chunk and Skv % chunk:
        pad = (-Skv) % chunk
        if kv_valid is None:
            kv_valid = torch.ones((B, Skv), dtype=torch.bool, device=q.device)
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad))
        kv_valid = F.pad(kv_valid, (0, pad))
        Skv += pad

    if Skv <= chunk:
        s = _scores(q, k, scale)
        mask = torch.ones((B, 1, 1, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask = kv_pos[:, None, None, :] <= q_pos[:, :, None, None]
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bqhc,bchd->bqhd", p.to(v.dtype), v)

    if kv_valid is None:
        kv_valid = torch.ones((B, Skv), dtype=torch.bool, device=q.device)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, dh), dtype=torch.float32, device=q.device)
    for c in range(0, Skv, chunk):
        kb, vb = k[:, c:c + chunk], v[:, c:c + chunk]
        s = _scores(q, kb, scale)
        mask = kv_valid[:, None, None, c:c + chunk]
        if causal:
            mask = mask & (kv_pos[:, None, None, c:c + chunk]
                           <= q_pos[:, :, None, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bqhc,bchd->bqhd", p.to(vb.dtype).float(), vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


class ParamTree(nn.Module):
    """A parameter tree — nested dicts and lists of tensors, the layout of
    the reference's ``init_params`` — as a module: each tensor a
    parameter, each dict or list a submodule, named after its path in the
    tree (``blocks.0.filt1.w``, ``layers.1.so2.2.wi``), so a state dict
    carries the reference's names. :meth:`tree` gives the tree back, the
    parameters themselves, for a functional ``forward(cfg, params, ...)``
    that a trainer can differentiate."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        self._keys = []
        for k, v in items:
            k = str(k)
            self._keys.append(k)
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, ParamTree(v))

    def tree(self):
        out = [self._parameters[k] if k in self._parameters
               else self._modules[k].tree() for k in self._keys]
        return out if self._is_list else dict(zip(self._keys, out))
