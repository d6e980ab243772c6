"""Decoder-only LM (dense + MoE): the twin of ``repro.models.transformer``.

Covers the five LM architectures of the configs (GQA + RoPE + SwiGLU +
RMSNorm; optional MoE FFN). The parameters are the reference's tree,
``blocks`` stacked on a leading ``[L, ...]`` axis (a
:class:`~repro_torch.models.layers.ParamTree` holds it as a module under
the reference's names); ``forward`` runs the layers in a Python loop
where the reference scans. Matrices keep ``param_dtype`` and are cast to
the activations' ``dtype`` where the reference casts them; norms and the
router stay float32. Under autograd with ``cfg.remat`` each layer runs
inside ``torch.utils.checkpoint`` and is recomputed in the backward, as
the reference's ``jax.checkpoint(layer, nothing_saveable)`` is: a step
keeps each layer's input and one layer's activations at a time.

:func:`decode_step` writes the new position's keys and values into the
cache it is given (in place: the reference's ``.at[].set`` makes the
same values in a fresh array) and attends over the whole cache as one
block. The reference's sharding rules, parameter and cache specs and
abstract parameters are JAX-mesh constructs with no counterpart on one
card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import threefry
from repro_torch.models.layers import (
    apply_rope,
    chunked_attention,
    rms_norm,
    truncated_normal,
)
from repro_torch.utils import resolve_device


def _dt(cfg: LMConfig):
    return getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# params


def init_params(cfg: LMConfig, key, device=None):
    """The reference's initial weights for the threefry ``key`` (the
    draw of ``init_params(cfg, jax.random.PRNGKey(...))``, within float32
    rounding before the cast to ``param_dtype``), drawn on ``device``
    (``None`` = the card)."""
    dev = resolve_device(device)
    _, pdt = _dt(cfg)
    d, L = cfg.d_model, cfg.n_layers
    dh, H, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    ks = threefry.split(key, 12)
    sc = 1.0 / np.sqrt(d)
    tn = lambda k, shape, scale: truncated_normal(k, shape, scale, pdt, dev)
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    blocks = dict(
        attn_norm=ones(L, d),
        wq=tn(ks[0], (L, d, H * dh), sc),
        wk=tn(ks[1], (L, d, Hkv * dh), sc),
        wv=tn(ks[2], (L, d, Hkv * dh), sc),
        wo=tn(ks[3], (L, H * dh, d), 1.0 / np.sqrt(H * dh)),
        mlp_norm=ones(L, d),
    )
    if cfg.moe is None:
        blocks.update(
            w_gate=tn(ks[4], (L, d, cfg.d_ff), sc),
            w_up=tn(ks[5], (L, d, cfg.d_ff), sc),
            w_down=tn(ks[6], (L, cfg.d_ff, d), 1.0 / np.sqrt(cfg.d_ff)),
        )
    else:
        blocks["moe"] = moe_lib.init_moe_params(ks[7], d, cfg.moe, L, pdt, dev)
    return dict(
        embed=tn(ks[8], (cfg.vocab, d), 1.0),
        blocks=blocks,
        final_norm=ones(d),
        lm_head=tn(ks[9], (cfg.vocab, d), sc),
    )


def unbind_layers(blocks: dict, n_layers: int) -> list:
    """Every layer's slice of the stacked ``blocks`` (views), one
    ``unbind`` a leaf: its backward stacks the layers' gradients into one
    tensor, where indexing each layer (``blocks[k][l]``) would give every
    layer a backward that writes a zero gradient of the whole stack."""
    parts = {k: unbind_layers(v, n_layers) if isinstance(v, dict)
             else v.unbind(0) for k, v in blocks.items()}
    return [{k: p[l] for k, p in parts.items()} for l in range(n_layers)]


# ---------------------------------------------------------------------------
# blocks


def _attention(cfg: LMConfig, bp, x, pos, cache=None, kv_valid=None):
    """x [B,S,D] → [B,S,D]; cache: dict(k,v [B,Smax,Hkv,dh], pos [B])."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt, _ = _dt(cfg)
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    q = (h @ bp["wq"].to(dt)).reshape(B, S, H, dh)
    kx = (h @ bp["wk"].to(dt)).reshape(B, S, Hkv, dh)
    vx = (h @ bp["wv"].to(dt)).reshape(B, S, Hkv, dh)
    q = apply_rope(q, pos, cfg.rope_theta)
    kx = apply_rope(kx, pos, cfg.rope_theta)

    if cache is not None:
        # decode: write the new kv at the running position, attend over
        # the cache
        cpos = cache["pos"]                                   # [B] int32
        bidx = torch.arange(B, device=x.device)
        k_all, v_all = cache["k"], cache["v"]
        k_all[bidx, cpos.long()] = kx[:, 0].to(k_all.dtype)
        v_all[bidx, cpos.long()] = vx[:, 0].to(v_all.dtype)
        Smax = k_all.shape[1]
        kv_pos = torch.arange(Smax, dtype=torch.int32,
                              device=x.device).expand(B, Smax)
        valid = kv_pos <= cpos[:, None]
        out = chunked_attention(q, k_all.to(dt), v_all.to(dt), pos, kv_pos,
                                kv_valid=valid,
                                chunk=max(Smax, cfg.attn_chunk), causal=False)
        new_cache = dict(k=k_all, v=v_all, pos=cpos)
    else:
        out = chunked_attention(q, kx, vx, pos, pos, kv_valid=kv_valid,
                                chunk=cfg.attn_chunk, causal=True)
        new_cache = dict(k=kx, v=vx)
    out = out.reshape(B, S, H * dh) @ bp["wo"].to(dt)
    return out, new_cache


def _ffn(cfg: LMConfig, bp, x):
    B, S, D = x.shape
    dt, _ = _dt(cfg)
    h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is None:
        g = h @ bp["w_gate"].to(dt)
        u = h @ bp["w_up"].to(dt)
        return (F.silu(g) * u) @ bp["w_down"].to(dt), {}
    y, aux = moe_lib.moe_layer(h.reshape(B * S, D), bp["moe"], cfg.moe)
    return y.reshape(B, S, D), aux


def _block(cfg: LMConfig, bp, x, pos, cache=None, kv_valid=None):
    a, new_cache = _attention(cfg, bp, x, pos, cache, kv_valid)
    x = x + a
    f, aux = _ffn(cfg, bp, x)
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# forward passes


def _embed(cfg, params, tokens):
    dt, _ = _dt(cfg)
    return F.embedding(tokens.long(), params["embed"]).to(dt)


def _logits(cfg, params, x):
    dt, _ = _dt(cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(dt).T


def forward(cfg: LMConfig, params, tokens, return_cache: bool = False):
    """Causal forward: tokens [B,S] → logits [B,S,V] (+ prefill KV cache
    ``extras["cache"]``: k, v [L,B,S,Hkv,dh])."""
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = _embed(cfg, params, tokens)
    ks, vs, aux = [], [], []
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in unbind_layers(params["blocks"], cfg.n_layers):
        if remat:
            # the layer draws no random numbers: no RNG state to replay
            x, cache, a = checkpoint(_block, cfg, bp, x, pos,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, cache, a = _block(cfg, bp, x, pos)
        if return_cache:
            ks.append(cache["k"])
            vs.append(cache["v"])
        if a:
            aux.append(a["load_balance"] + a["router_z"])
    logits = _logits(cfg, params, x)
    extras = dict(aux_loss=torch.stack(aux).sum() if cfg.moe is not None
                  else torch.zeros((), device=x.device))
    if return_cache:
        extras["cache"] = dict(k=torch.stack(ks), v=torch.stack(vs))
    return logits, extras


def loss_fn(cfg: LMConfig, params, tokens):
    """Next-token cross-entropy (float32 logsumexp) plus the MoE aux loss."""
    logits, extras = forward(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:]
    lf = logits.float()
    lz = torch.logsumexp(lf, -1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = (lz - gold).mean()
    return nll + extras["aux_loss"], dict(nll=nll, **extras)


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """An empty KV cache on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)[0]
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return dict(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def decode_step(cfg: LMConfig, params, cache, tokens):
    """One serve step: tokens [B,1] + KV cache → logits [B,1,V], new cache
    (the same k, v tensors, written in place; ``pos`` one further)."""
    pos = cache["pos"][:, None]                               # [B,1]
    x = _embed(cfg, params, tokens)
    for l, bp in enumerate(unbind_layers(params["blocks"], cfg.n_layers)):
        x, _, _ = _block(cfg, bp, x, pos,
                         cache=dict(k=cache["k"][l], v=cache["v"][l],
                                    pos=cache["pos"]))
    logits = _logits(cfg, params, x)
    return logits, dict(k=cache["k"], v=cache["v"], pos=cache["pos"] + 1)
