"""wedge_check: keyed lower bound of push queries in their owners' rows.

The wrapper launches the CUDA kernel (``csrc/wedge_check.cu``) for CUDA
tensors and takes the plain PyTorch version for CPU tensors; the device
alone decides (meta tensors: the kernel's output shapes,
:mod:`repro_torch.kernels._meta`). It replaces the JAX package's
``kernels/wedge_check/wedge_check.py::wedge_check_pallas``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _cuda, _meta
from repro_torch.utils import u32_key

launches = 0   # kernel launches made by this wrapper (not by the plain path)

# tripoll_wedge_check(kd, kh, ki, S, E, lo, hi, qd, qh, qi, B, out, stream)
ARGTYPES = ([_cuda.PTR] * 3 + [_cuda.I64] * 2 + [_cuda.PTR] * 5 + [_cuda.I64]
            + [_cuda.PTR] * 2)


def lower_bound_steps(n: int) -> int:
    """Fixed step count that settles a binary search over ``n`` slots."""
    return max(1, int(np.ceil(np.log2(max(2, n)))) + 1)


def wedge_check_plain(keys_d, keys_h, keys_i, lo, hi, qd, qh, qi):
    """Plain PyTorch version: ``keys_*`` [S, E], queries [S, B] → [S, B]
    int32 positions local to each shard's key arrays. ``keys_h``/``qh``
    are uint32 bits in int32 and compare unsigned (sign-flipped)."""
    E = keys_d.shape[-1]
    khk, qhk = u32_key(keys_h), u32_key(qh)
    for _ in range(lower_bound_steps(E)):
        has = lo < hi
        mid = torch.where(has, (lo + hi) // 2, 0)
        m = mid.clamp(0, E - 1).long()
        d = torch.gather(keys_d, 1, m)
        h = torch.gather(khk, 1, m)
        i = torch.gather(keys_i, 1, m)
        less = (d < qd) | ((d == qd) & (h < qhk)) | ((d == qd) & (h == qhk) & (i < qi))
        lo = torch.where(has & less, mid + 1, lo)
        hi = torch.where(has & ~less, mid, hi)
    return lo


def wedge_check(keys_d, keys_h, keys_i, lo, hi, qd, qh, qi):
    """Lower bound of (qd, qh, qi) within [lo, hi) of each shard's sorted
    key arrays. Shapes: ``keys_*`` [S, E]; ``lo, hi, q*`` [S, B]; all
    int32 (``keys_h``, ``qh`` hold uint32 bits). Returns [S, B] int32.

    One CUDA launch covers all S shards."""
    if keys_d.device.type == "cpu":
        return wedge_check_plain(keys_d, keys_h, keys_i, lo, hi, qd, qh, qi)
    if keys_d.device.type == "meta":
        return _meta.call("wedge_check", keys_d, keys_h, keys_i, lo, hi, qd,
                          qh, qi)
    if keys_d.device.type != "cuda":
        raise ValueError(f"wedge_check: unsupported device {keys_d.device}")
    global launches
    dev = keys_d.device
    S, E = keys_d.shape
    B = lo.shape[-1]
    for name, t, shape in (("keys_d", keys_d, (S, E)), ("keys_h", keys_h, (S, E)),
                           ("keys_i", keys_i, (S, E)), ("lo", lo, (S, B)),
                           ("hi", hi, (S, B)), ("qd", qd, (S, B)),
                           ("qh", qh, (S, B)), ("qi", qi, (S, B))):
        _cuda.check(f"wedge_check {name}", t, torch.int32, shape, dev)
    out = torch.empty((S, B), dtype=torch.int32, device=dev)
    if S == 0 or B == 0:
        return out
    fn = _cuda.function("wedge_check", "tripoll_wedge_check", ARGTYPES)
    P = _cuda.ptr
    err = fn(P(keys_d), P(keys_h), P(keys_i), S, E, P(lo), P(hi), P(qd),
             P(qh), P(qi), B, P(out), _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        launches += 1
    _cuda.raise_on_error("wedge_check", err)
    return out
