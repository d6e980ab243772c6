"""Embedding lookup / EmbeddingBag: the twin of
``repro.models.recsys.embedding``.

The reference builds its bag from ``jnp.take`` + ``segment_sum`` outside
any kernel, so gathers and sums of PyTorch are the port. Its tables
row-shard over a JAX mesh's ``model`` axis; on one card a table is one
tensor.

Out-of-range ids follow ``jnp.take``'s default (fill) mode: an id in
[-n, 0) counts from the end, and an id ≥ n or < -n gives a row of NaN
(``torch.index_select`` would raise). Such a row's gradient is dropped,
as the reference's is.

The bag's segments are contiguous runs of K (the reference's
``jnp.repeat(arange(B), K)``), so its ``segment_sum`` is a
``view(B, K, d).sum(1)``: the same function, summed in one fixed order on
the card. ``index_add_`` over the segment ids would compute it too, but
its float atomics make the order, and so the rounding, differ from run
to run.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal


def init_table(key, n_rows: int, dim: int, dtype=torch.float32, device=None):
    return truncated_normal(key, (n_rows, dim), 1.0 / np.sqrt(dim), dtype,
                            device)


def embedding_lookup(table, ids):
    """Plain row gather: ids [...] → [..., dim], as ``jnp.take(table,
    ids, axis=0)``: negative ids from the end, rows out of range NaN."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), table)
    return torch.where(inside[..., None], rows, float("nan"))


def embedding_bag(table, ids, valid=None, mode: str = "mean"):
    """Multi-hot pooled lookup: ids [B, K] → [B, dim].

    One gather of the B·K ids, masked by ``valid`` (padded id slots; the
    mask multiplies, so a NaN row stays NaN), summed over each bag;
    ``mode="mean"`` divides by K, or by the bag's valid count (at least
    1)."""
    B, K = ids.shape
    flat = embedding_lookup(table, ids.reshape(-1))          # [B·K, dim]
    if valid is not None:
        flat = flat * valid.reshape(-1, 1).to(flat.dtype)
    out = flat.view(B, K, -1).sum(1)
    if mode == "sum":
        return out
    if valid is None:
        return out / K
    cnt = valid.sum(-1, keepdim=True).to(out.dtype)
    return out / torch.clamp_min(cnt, 1.0)
