"""Cyclic vertex partitioning (paper Sec. 4.2).

Vertex ``v`` is owned by shard ``v % S`` and stored at local row ``v // S``,
so ownership needs no lookup tables on the device.
"""
from __future__ import annotations


def owner_of(v, S: int):
    """Shard owning global vertex id ``v`` (numpy / torch / python ints)."""
    return v % S


def local_of(v, S: int):
    """Local row of ``v`` on its owner shard."""
    return v // S


def global_of(owner, local, S: int):
    """Inverse of (owner_of, local_of)."""
    return local * S + owner


def n_local(n_global: int, S: int) -> int:
    """Rows per shard (cyclic partition of ``n_global`` ids)."""
    return -(-n_global // S)
