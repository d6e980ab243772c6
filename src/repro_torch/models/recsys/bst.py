"""Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874]: the twin of
``repro.models.recsys.bst``.

Published config: embed_dim=32, seq_len=20, n_blocks=1, n_heads=8, MLP
1024-512-256. The user's clicked-item sequence + the target item pass
through a post-LN transformer block; its flattened output concatenates
with bag-pooled side features into the ranking MLP (CTR logit).
``retrieval_scores`` scores one query against a slab of candidates as
one product.

The parameters are the reference's tree (lists ``field_tables``,
``blocks``, ``mlp``), drawn from the same threefry keys in the same
order; :class:`BST`, a :class:`~repro_torch.models.layers.ParamTree`,
holds it as a module under the reference's names. The dtypes flow as in the reference: layer norms in the
activations' dtype; the attention scores, scaled by a float32 1/√dh,
float32 through the softmax, then cast back; the loss on float32
logits. The reference's ``param_specs`` and ``rules`` are shardings for
a JAX mesh, with no counterpart on one card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecSysConfig
from repro_torch.models import threefry
from repro_torch.models.layers import ParamTree, truncated_normal
from repro_torch.models.recsys.embedding import (embedding_bag,
                                                 embedding_lookup, init_table)
from repro_torch.utils import resolve_device


def _dense(key, din, dout, dtype, device):
    return dict(w=truncated_normal(key, (din, dout), 1.0 / np.sqrt(din), dtype,
                                   device),
                b=torch.zeros((dout,), dtype=dtype, device=device))


def _apply(p, x):
    return x @ p["w"] + p["b"]


def _ln(x, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def init_params(cfg: RecSysConfig, key, device=None):
    """The reference's initial weights for the threefry ``key`` (the draw
    of ``init_params(cfg, jax.random.PRNGKey(...))``, within float32
    rounding before the cast to ``cfg.dtype``), drawn on ``device``
    (``None`` = the card)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    d = cfg.embed_dim
    ks = iter(threefry.split(key, 16 + 4 * cfg.n_blocks + len(cfg.mlp_dims)))
    p = dict(
        item_table=init_table(next(ks), cfg.n_items, d, dt, dev),
        field_tables=[init_table(next(ks), cfg.vocab_per_field, d, dt, dev)
                      for _ in range(cfg.n_sparse_fields)],
        pos_embed=truncated_normal(next(ks), (cfg.seq_len + 1, d), 0.02, dt,
                                   dev),
        blocks=[],
    )
    for _ in range(cfg.n_blocks):
        p["blocks"].append(dict(
            wq=_dense(next(ks), d, d, dt, dev),
            wk=_dense(next(ks), d, d, dt, dev),
            wv=_dense(next(ks), d, d, dt, dev),
            wo=_dense(next(ks), d, d, dt, dev),
            ff1=_dense(next(ks), d, 4 * d, dt, dev),
            ff2=_dense(next(ks), 4 * d, d, dt, dev),
        ))
    mlp_in = (cfg.seq_len + 1) * d + cfg.n_sparse_fields * d
    dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
    p["mlp"] = [_dense(next(ks), a, b, dt, dev)
                for a, b in zip(dims[:-1], dims[1:])]
    return p


def _block(cfg: RecSysConfig, bp, x):
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    q = _apply(bp["wq"], x).reshape(B, S, H, dh)
    k = _apply(bp["wk"], x).reshape(B, S, H, dh)
    v = _apply(bp["wv"], x).reshape(B, S, H, dh)
    # the reference divides by a numpy float64 scalar, a float32 without x64
    s = (torch.einsum("bqhd,bkhd->bhqk", q, k).float()
         / np.float32(np.sqrt(dh)))
    a = torch.softmax(s, -1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, d)
    x = _ln(x + _apply(bp["wo"], o)).to(x.dtype)
    h = torch.relu(_apply(bp["ff1"], x))
    return _ln(x + _apply(bp["ff2"], h)).to(x.dtype)


def forward(cfg: RecSysConfig, params, batch):
    """batch: hist [B,S] item ids, target [B], fields [B,F,K] multi-hot ids,
    field_valid [B,F,K]. → CTR logits [B]."""
    hist, target = batch["hist"], batch["target"]
    B, S = hist.shape
    seq_ids = torch.cat([hist, target[:, None]], 1)            # [B, S+1]
    x = embedding_lookup(params["item_table"], seq_ids)
    x = x + params["pos_embed"][None]
    for bp in params["blocks"]:
        x = _block(cfg, bp, x)
    flat = x.reshape(B, -1)

    pooled = [embedding_bag(t, batch["fields"][:, f],
                            batch["field_valid"][:, f], mode="mean")
              for f, t in enumerate(params["field_tables"])]
    h = torch.cat([flat] + pooled, -1)
    for i, mp in enumerate(params["mlp"]):
        h = _apply(mp, h)
        if i + 1 < len(params["mlp"]):
            h = F.leaky_relu(h, 0.01)
    return h[:, 0]


def loss_fn(cfg: RecSysConfig, params, batch):
    logits = forward(cfg, params, batch).float()
    labels = batch["label"].float()
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
    return loss, dict(nll=loss)


def retrieval_scores(cfg: RecSysConfig, params, batch):
    """Score one user query (``hist`` [1, S]) against the candidates
    ``cand_ids`` [C]: one product over the candidate slab (no loop) →
    float32 [C]."""
    x = embedding_lookup(params["item_table"], batch["hist"])
    x = x + params["pos_embed"][None, :-1]
    for bp in params["blocks"]:
        x = _block(cfg, bp, x)
    q = x.mean(1)                                              # [1, d] user vec
    cand = embedding_lookup(params["item_table"], batch["cand_ids"])  # [C, d]
    return (cand @ q[0]).float()                               # [C]


class BST(ParamTree):
    """BST as a module: ``forward(batch)`` → CTR logits [B].

    ``params`` is a tree from :func:`init_params` (or carried from the
    JAX package, see :func:`repro_torch.interop.recsys_params_from_jax`);
    without one, the weights are drawn from the threefry ``key`` (default
    ``threefry.prng_key(0)``, the reference's ``PRNGKey(0)``) on
    ``device`` (``None`` = the card)."""

    def __init__(self, cfg: RecSysConfig, params: dict | None = None, *,
                 key=None, device=None):
        super().__init__(init_params(cfg, threefry.prng_key(0) if key is None
                                     else key, device)
                         if params is None else params)
        self.cfg = cfg

    def forward(self, batch):
        return forward(self.cfg, self.tree(), batch)
