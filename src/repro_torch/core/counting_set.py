"""Distributed counting set (paper Sec. 4.1.4), one table per shard.

Each shard keeps a fixed-capacity counting table; the cross-shard merge is
an elementwise add of counts and max of the packed records (same hash ⇒
same slots). Collisions are detected by a check hash (per-slot max and
complemented min) and reported, never merged into wrong keys.

State is ``{count: [cap] int32, packed: [cap, K+2] uint32 bits in int32}``
(see the uint32 rule in :mod:`repro_torch.utils`): ``packed[:, :K]`` holds
sign-flipped keys, ``packed[:, K]`` the check-hash max and
``packed[:, K+1]`` the complemented check-hash min; all-zero bits are the
identity of every column under unsigned max.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.fold_scatter import ops as fs_ops
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.utils import INT32_MIN, MASK32, splitmix32, u32_bits, u32_key

_CHK_SEED = 0x9E3779B9


def _fold_keys(keys: torch.Tensor, seeds: tuple) -> torch.Tensor:
    """Mix K int32 key columns [B, K] into one uint32 per row and seed:
    [len(seeds), B] int64 values in [0, 2³²). Both seeds fold in one pass
    (half the launches of two)."""
    acc = torch.tensor(seeds, dtype=torch.int64, device=keys.device)
    acc = acc.view((-1,) + (1,) * (keys.dim() - 1)).expand(
        (len(seeds),) + tuple(keys.shape[:-1]))
    cols = keys.to(torch.int64) & MASK32
    for k in range(keys.shape[-1]):
        acc = splitmix32(acc ^ cols[..., k])
    return acc


def umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned max of two uint32-bits int32 tensors."""
    return u32_key(torch.maximum(u32_key(a), u32_key(b)))


@dataclass(frozen=True)
class CountingSet:
    """Factory for counting-table state and its increment / merge ops.

    ``backend`` picks the fold, as in the JAX package: ``"auto"`` and
    ``"pallas"`` take the fused ``fold_count_max``, ``"scatter"`` the two
    unfused scatters ``hist_add`` and ``hist_max``. The tables are bitwise
    the same either way. Each is the CUDA kernel for tensors on the card
    and its plain PyTorch version on the CPU. ``pallas_interpret`` is kept
    so configurations compare field by field with the JAX package; it
    selects nothing here.
    """

    capacity: int
    n_key_cols: int
    backend: str = "auto"
    pallas_interpret: bool | None = None

    def __post_init__(self):
        if self.backend not in ("auto", "pallas", "scatter"):
            raise ValueError(f"unknown CountingSet backend {self.backend!r}")

    def init(self, device) -> dict:
        cap, k = self.capacity, self.n_key_cols
        return dict(
            count=torch.zeros((cap,), dtype=torch.int32, device=device),
            packed=torch.zeros((cap, k + 2), dtype=torch.int32, device=device),
        )

    def increment(self, state: dict, keys: torch.Tensor, valid: torch.Tensor,
                  amount=1) -> dict:
        """keys [B, K] int32, valid [B] bool: scatter into fresh tables
        (invalid rows go to slot -1, which the fold drops), combined with
        the state (add; unsigned max)."""
        cap = self.capacity
        mixed = _fold_keys(keys, (0, _CHK_SEED))
        slot = torch.where(valid, (mixed[0] % cap).to(torch.int32), -1)
        chk = mixed[1]
        row = torch.cat([keys ^ INT32_MIN, u32_bits(chk)[:, None],
                         u32_bits(chk ^ MASK32)[:, None]], dim=-1)
        zero = torch.zeros((), dtype=torch.int32, device=keys.device)
        row = torch.where(valid[:, None], row, zero)
        amt = torch.where(valid, torch.full_like(slot, int(amount)), zero)
        if self.backend == "scatter":
            d_count = hist_ops.hist_add(slot, amt, cap)
            d_packed = hist_ops.hist_max(slot, row, cap)
        else:
            d_count, d_packed = fs_ops.fold_count_max(slot, amt, row, cap)
        return dict(count=state["count"] + d_count,
                    packed=umax(state["packed"], d_packed))

    def merge(self, stacked: dict) -> dict:
        """Merge tables stacked on axis 0 (the cross-shard reduce)."""
        return dict(
            count=stacked["count"].sum(0, dtype=torch.int32),
            packed=u32_key(u32_key(stacked["packed"]).amax(0)),
        )

    def merge_epochs(self, prev: dict, delta: dict) -> dict:
        return dict(count=prev["count"] + delta["count"],
                    packed=umax(prev["packed"], delta["packed"]))

    def finalize(self, merged: dict) -> dict:
        """Host-side read-out: {key_tuple: count}, plus collision report."""
        count = merged["count"].cpu().numpy()
        packed = merged["packed"].cpu().numpy().view(np.uint32)
        k = self.n_key_cols
        keys = (packed[:, :k] ^ np.uint32(0x80000000)).astype(np.int64)
        keys[keys >= 2**31] -= 2**32
        chk_max = packed[:, k]
        chk_min = ~packed[:, k + 1]
        used = count > 0
        collided = used & (chk_min != chk_max)
        out = {}
        for i in np.nonzero(used & ~collided)[0]:
            out[tuple(int(x) for x in keys[i])] = int(count[i])
        return dict(
            counts=out,
            n_collided_slots=int(collided.sum()),
            count_in_collided=int(count[collided].sum()),
        )
