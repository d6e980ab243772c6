"""Synthetic LM token stream: a deterministic function of (seed, step).

The twin of ``repro.data.tokens``, bit for bit: the same threefry keys
(:mod:`repro_torch.models.threefry`), the same ``randint`` draws. Token
t+1 is a mixed function of token t and a per-sequence drift, so the
stream has learnable bigram statistics.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import threefry
from repro_torch.utils import resolve_device


def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
             device=None) -> torch.Tensor:
    """int32 tokens [batch, seq_len] on ``device`` (``None`` = the card),
    equal to ``repro.data.lm_batch(seed, step, batch, seq_len, vocab)``."""
    key = threefry.fold_in(threefry.prng_key(seed), step)
    k1, k2, k3 = threefry.split(key, 3)
    base = threefry.randint(k1, (batch, 1), 0, vocab).astype(np.int64)
    drift = threefry.randint(k2, (batch, 1), 1, 7).astype(np.int64)
    t = np.arange(seq_len, dtype=np.int64)[None, :]
    noise = threefry.randint(k3, (batch, seq_len), 0, max(2, vocab // 16))
    toks = (base + drift * t + noise) % vocab
    return torch.from_numpy(toks.astype(np.int32)).to(resolve_device(device))
