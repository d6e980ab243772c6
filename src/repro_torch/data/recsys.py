"""Synthetic CTR batches for BST: clicks correlate with history overlap.

The twin of ``repro.data.recsys``, bit for bit: the same threefry keys
and the same ``randint`` / ``bernoulli`` draws, made on the device by the
twins in :mod:`repro_torch.models.threefry` (a bulk batch holds millions
of ids, too many to hash on the host for each request).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.models import threefry
from repro_torch.utils import resolve_device


def recsys_batch(cfg: RecSysConfig, seed: int, step: int, batch: int,
                 bag_size: int = 4, device=None) -> dict:
    """``repro.data.recsys_batch(cfg, seed, step, batch, bag_size)`` on
    ``device`` (``None`` = the card): ``hist`` [B, S], ``target`` [B] and
    ``fields`` [B, F, K] int32; ``field_valid`` [B, F, K] and ``label``
    [B] bool."""
    dev = resolve_device(device)
    key = threefry.fold_in(threefry.prng_key(seed), step)
    ks = threefry.split(key, 6)
    F = cfg.n_sparse_fields
    hist = threefry.torch_randint(ks[0], (batch, cfg.seq_len), 0, cfg.n_items,
                                  dev)
    target = threefry.torch_randint(ks[1], (batch,), 0, cfg.n_items, dev)
    fields = threefry.torch_randint(ks[2], (batch, F, bag_size), 0,
                                    cfg.vocab_per_field, dev)
    field_valid = threefry.torch_bernoulli(ks[3], 0.8, (batch, F, bag_size),
                                           dev)
    field_valid[:, :, 0] = True
    # label depends on (target mod k) colliding with history mod k → learnable
    sig = (hist % 97 == (target % 97)[:, None]).any(-1)
    noise = threefry.torch_bernoulli(ks[4], 0.1, (batch,), dev)
    return dict(hist=hist, target=target, fields=fields,
                field_valid=field_valid, label=torch.logical_xor(sig, noise))
