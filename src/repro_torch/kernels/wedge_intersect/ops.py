"""wedge_intersect: fused candidate addressing + lower bound in pulled rows.

The wrapper launches the CUDA kernel (``csrc/wedge_intersect.cu``) for
CUDA tensors and takes the plain PyTorch version for CPU tensors; the
device alone decides (meta tensors: the kernel's output shapes,
:mod:`repro_torch.kernels._meta`). It replaces the JAX package's
``kernels/wedge_intersect/wedge_intersect.py::wedge_intersect_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, _meta
from repro_torch.kernels.wedge_check.ops import lower_bound_steps
from repro_torch.utils import u32_key

launches = 0   # kernel launches made by this wrapper (not by the plain path)

# tripoll_wedge_intersect(kd, kh, ki, E, e, rd, rh, ri, ln, B, Lr, L, pos,
#                         ci, stream)
ARGTYPES = ([_cuda.PTR] * 3 + [_cuda.I64] + [_cuda.PTR] * 5
            + [_cuda.I64, _cuda.I32, _cuda.I32] + [_cuda.PTR] * 3)


def wedge_intersect_plain(keys_d, keys_h, keys_i, e, row_d, row_h, row_i, ln,
                          L: int):
    """Plain PyTorch version: ``keys_*`` [E]; ``e`` [B]; rows [B, Lr];
    ``ln`` [B] → ``(pos, ci)`` [B, L] int32. Candidate ``k`` of edge ``b``
    is the key at ``clamp(e + 1 + k, 0, E - 1)``; ``pos`` is its lower
    bound in the row prefix of length ``ln``."""
    E = keys_d.shape[0]
    Lr = row_d.shape[-1]
    k = torch.arange(L, dtype=torch.int32, device=e.device)
    idx = (e[:, None] + 1 + k[None, :]).clamp(0, E - 1).long()
    cd, ch, ci = keys_d[idx], u32_key(keys_h)[idx], keys_i[idx]
    rhk = u32_key(row_h)
    lo = torch.zeros_like(ci)
    hi = ln[:, None].expand_as(ci)
    for _ in range(lower_bound_steps(max(L, Lr))):
        has = lo < hi
        mid = torch.where(has, (lo + hi) // 2, 0)
        m = mid.clamp(0, max(Lr - 1, 0)).long()
        d = torch.gather(row_d, 1, m)
        h = torch.gather(rhk, 1, m)
        i = torch.gather(row_i, 1, m)
        less = (d < cd) | ((d == cd) & (h < ch)) | ((d == cd) & (h == ch) & (i < ci))
        lo = torch.where(has & less, mid + 1, lo)
        hi = torch.where(has & ~less, mid, hi)
    return lo, ci


def wedge_intersect(keys_d, keys_h, keys_i, e, row_d, row_h, row_i, ln,
                    L: int):
    """Shapes: ``keys_*`` [E] (one shard's sorted key arrays); ``e`` [B]
    edge slots; ``row_*`` [B, Lr] pulled rows with valid prefix ``ln`` [B];
    all int32 (``keys_h``, ``row_h`` hold uint32 bits). Returns ``(pos,
    ci)``, both [B, L] int32."""
    if keys_d.device.type == "cpu":
        return wedge_intersect_plain(keys_d, keys_h, keys_i, e, row_d, row_h,
                                     row_i, ln, L)
    if keys_d.device.type == "meta":
        return _meta.call("wedge_intersect", keys_d, keys_h, keys_i, e, row_d,
                          row_h, row_i, ln, L)
    if keys_d.device.type != "cuda":
        raise ValueError(f"wedge_intersect: unsupported device {keys_d.device}")
    global launches
    dev = keys_d.device
    E = keys_d.shape[0]
    B, Lr = row_d.shape
    for name, t, shape in (("keys_d", keys_d, (E,)), ("keys_h", keys_h, (E,)),
                           ("keys_i", keys_i, (E,)), ("e", e, (B,)),
                           ("row_d", row_d, (B, Lr)), ("row_h", row_h, (B, Lr)),
                           ("row_i", row_i, (B, Lr)), ("ln", ln, (B,))):
        _cuda.check(f"wedge_intersect {name}", t, torch.int32, shape, dev)
    pos = torch.empty((B, L), dtype=torch.int32, device=dev)
    ci = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return pos, ci
    if E == 0 or Lr == 0:
        raise ValueError("wedge_intersect: empty key arrays or rows")
    fn = _cuda.function("wedge_intersect", "tripoll_wedge_intersect",
                        ARGTYPES)
    P = _cuda.ptr
    err = fn(P(keys_d), P(keys_h), P(keys_i), E, P(e), P(row_d), P(row_h),
             P(row_i), P(ln), B, Lr, L, P(pos), P(ci),
             _cuda.stream_handle(dev))
    with _cuda.COUNT_LOCK:
        launches += 1
    _cuda.raise_on_error("wedge_intersect", err)
    return pos, ci
