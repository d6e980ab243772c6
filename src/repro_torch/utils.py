"""Shared helpers: hashing, padding, integer helpers, uint32 lanes.

The uint32 rule of the port: every uint32 lane of the reference (vertex
hashes ``nbr_h``, reply hashes ``r_h``, the packed counting table, the
counter64 limbs) is stored as an int32 tensor holding the same bit
pattern. That keeps the reference's bytes, and the CUDA kernels read the
lanes as ``unsigned``. Mixer arithmetic runs in int64 masked to 32 bits;
unsigned order compares flip the sign bit (:func:`u32_key`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "splitmix32",
    "splitmix32_np",
    "key_less",
    "ceil_div",
    "pad_to",
    "pad_axis_to",
    "bucket_cap",
    "bucket_floor",
    "bucket_caps",
    "u32_key",
    "u32_bits",
    "resolve_device",
]

INT32_MIN = -(2**31)
MASK32 = 0xFFFFFFFF

# geometric shape-bucket grid: within each power-of-two octave [2^k, 2^(k+1))
# the rungs approximate ceil(2^k · 2^(j/4)), j = 0..3, as exact integer
# fractions so the grid is identical on every host
_BUCKET_RUNGS = ((1, 1), (19, 16), (45, 32), (27, 16))


def bucket_cap(x: int) -> int:
    """Smallest bucket-grid value ≥ ``x`` (0 and 1 are their own buckets);
    idempotent and monotone."""
    x = int(x)
    if x <= 1:
        return max(x, 0)
    k = x.bit_length() - 1
    if (1 << k) == x:
        return x
    for kk in (k, k + 1):
        base = 1 << kk
        for num, den in _BUCKET_RUNGS:
            v = -(-base * num // den)
            if v >= x:
                return v
    raise AssertionError(f"bucket grid has no rung >= {x}")  # unreachable


def bucket_floor(x: int) -> int:
    """Largest bucket-grid value ≤ ``x`` — the round-down twin of
    :func:`bucket_cap`."""
    x = int(x)
    if x <= 1:
        return max(x, 0)
    k = x.bit_length() - 1
    best = 1 << k
    for num, den in _BUCKET_RUNGS:
        v = -(-(1 << k) * num // den)
        if v <= x:
            best = max(best, v)
    return best


def bucket_caps(a: np.ndarray) -> np.ndarray:
    """Elementwise :func:`bucket_cap` over an integer array (host-side)."""
    flat = np.asarray(a, np.int64).ravel()
    return np.array([bucket_cap(int(x)) for x in flat],
                    np.int64).reshape(np.shape(a))


def splitmix32_np(x: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit mixer (host, uint32 in and out)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x).astype(np.uint32)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """The same mixer on tensors: int64 values in [0, 2³²) in and out.

    Every product stays below 2⁶³, so int64 arithmetic masked to 32 bits
    is bit-identical to :func:`splitmix32_np`."""
    x = x & MASK32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → int32 tensor with the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def u32_key(x: torch.Tensor) -> torch.Tensor:
    """int32-stored uint32 lane → int32 whose signed order is the
    unsigned order of the lane (sign-bit flip, an involution)."""
    return x ^ INT32_MIN


def key_less(d1, h1, i1, d2, h2, i2):
    """Lexicographic ``(degree, hash, id) <`` on numpy arrays whose hash
    columns are uint32 — the paper's ``<₊`` total order."""
    return (
        (d1 < d2)
        | ((d1 == d2) & (h1 < h2))
        | ((d1 == d2) & (h1 == h2) & (i1 < i2))
    )


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad a 1-D array to length ``n`` with ``fill``."""
    if x.shape[0] > n:
        raise ValueError(f"cannot pad length {x.shape[0]} down to {n}")
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def pad_axis_to(x: np.ndarray, axis: int, n: int, fill=0) -> np.ndarray:
    if x.shape[axis] > n:
        raise ValueError(f"cannot pad axis {axis} of {x.shape} to {n}")
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return np.pad(x, pad, constant_values=fill)


def sync(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (nothing to wait for off the
    card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resolve_device(device) -> torch.device:
    """``None`` means the card. There is no CPU fallback: asking for CUDA
    where there is none raises; pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
