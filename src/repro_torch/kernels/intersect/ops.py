"""intersect: per-lane keyed lower bound of candidates in pulled rows (the
split pull lane).

The wrapper launches the CUDA kernel (``csrc/intersect.cu``) for CUDA
tensors and takes the plain PyTorch version for CPU tensors; the device
alone decides (meta tensors: the kernel's output shapes,
:mod:`repro_torch.kernels._meta`). It replaces the JAX package's
``kernels/intersect/intersect.py::intersect_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, _meta
from repro_torch.kernels.wedge_check.ops import lower_bound_steps
from repro_torch.utils import u32_key

launches = 0   # kernel launches made by this wrapper (not by the plain path)


def intersect_plain(row_d, row_h, row_i, ln, qd, qh, qi):
    """Plain PyTorch version: rows and candidates [B, L], ``ln`` [B] →
    [B, L] int32 lower-bound positions of each candidate in its row's
    prefix of length ``clamp(ln, 0, L)``."""
    L = qd.shape[-1]
    rhk, qhk = u32_key(row_h), u32_key(qh)
    lo = torch.zeros_like(qi)
    hi = ln.clamp(0, L)[:, None].expand_as(qi)
    for _ in range(lower_bound_steps(L)):
        has = lo < hi
        mid = torch.where(has, (lo + hi) // 2, 0)
        m = mid.clamp(0, max(L - 1, 0)).long()
        d = torch.gather(row_d, 1, m)
        h = torch.gather(rhk, 1, m)
        i = torch.gather(row_i, 1, m)
        less = (d < qd) | ((d == qd) & (h < qhk)) | ((d == qd) & (h == qhk) & (i < qi))
        lo = torch.where(has & less, mid + 1, lo)
        hi = torch.where(has & ~less, mid, hi)
    return lo


def intersect(row_d, row_h, row_i, ln, qd, qh, qi):
    """Lower bound of each candidate ``(qd, qh, qi)[b, k]`` in row ``b``
    ``(row_d, row_h, row_i)[b, :ln[b]]`` under the (degree, hash unsigned,
    id) order. Shapes: rows and candidates [B, L]; ``ln`` [B] with
    0 ≤ ln ≤ L (clamped); all int32 (``row_h``, ``qh`` hold uint32 bits).
    Returns [B, L] int32. Hits are ``pos < ln`` and ``row_i[pos] == qi``."""
    if qd.device.type == "cpu":
        return intersect_plain(row_d, row_h, row_i, ln, qd, qh, qi)
    if qd.device.type == "meta":
        return _meta.call("intersect", row_d, row_h, row_i, ln, qd, qh, qi)
    if qd.device.type != "cuda":
        raise ValueError(f"intersect: unsupported device {qd.device}")
    global launches
    dev = qd.device
    B, L = qd.shape
    for name, t, shape in (("row_d", row_d, (B, L)), ("row_h", row_h, (B, L)),
                           ("row_i", row_i, (B, L)), ("ln", ln, (B,)),
                           ("qd", qd, (B, L)), ("qh", qh, (B, L)),
                           ("qi", qi, (B, L))):
        _cuda.check(f"intersect {name}", t, torch.int32, shape, dev)
    pos = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return pos
    fn = _cuda.function("intersect", "tripoll_intersect",
                        [_cuda.PTR] * 7 + [_cuda.I64, _cuda.I32]
                        + [_cuda.PTR] * 2)
    P = _cuda.ptr
    err = fn(P(row_d), P(row_h), P(row_i), P(ln), P(qd), P(qh), P(qi), B, L,
             P(pos), _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        launches += 1
    _cuda.raise_on_error("intersect", err)
    return pos
