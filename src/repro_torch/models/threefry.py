"""The JAX package's default random numbers, on the host in numpy.

The JAX package draws its models' initial weights from ``jax.random``:
Threefry-2x32 keys, split and hashed in the "partitionable" layout (the
default of the JAX release the reference runs on), uniform floats from
the hashed bits, and truncated normals through the inverse error
function. This module copies those steps so that a port model seeded
with :func:`prng_key` starts from the same weights as the reference's
model seeded with ``jax.random.PRNGKey`` — and so that an example trains
along the same path on either package.

A key is a numpy ``uint32`` array of shape ``(2,)``. Integer steps are
exact; the float steps follow XLA's float32 arithmetic operation for
operation (``erf_inv`` is Giles' single-precision polynomial, as XLA
computes it; numpy's ``log1p`` is not XLA's), so a truncated normal
lies within a few float32 roundings of the reference's (7.2e-7 at most
over 19,200 draws) and the bits and uniforms are the reference's
exactly. :func:`fold_in`, :func:`randint` (``int32``) and
:func:`bernoulli` are exact.

:func:`torch_random_bits`, :func:`torch_uniform`,
:func:`torch_truncated_normal`, :func:`torch_randint` and
:func:`torch_bernoulli` are the same draws as torch tensors on a given
device, for weights and batches too large to draw on the host (a
full-width LM holds billions of weights, a bulk recsys batch millions of
ids): the same bits, uniforms, integers and booleans, and normals within
a float32 rounding of this module's (``log1p`` is the device's).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["prng_key", "split", "fold_in", "random_bits", "uniform",
           "truncated_normal", "randint", "bernoulli", "torch_random_bits",
           "torch_uniform", "torch_truncated_normal", "torch_randint",
           "torch_bernoulli"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default,
    the reference's): the seed's low 32 bits, after a high word of 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counts(shape) -> tuple[np.ndarray, np.ndarray]:
    """The flat index of every element as (high, low) 32-bit words."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: a ``[num, 2]`` array of keys."""
    hi, lo = _counts((num,))
    b0, b1 = _threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the count (0, data)."""
    b0, b1 = _threefry2x32(key, np.zeros(1, np.uint32),
                           np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits an element (``jax.random.bits``)."""
    hi, lo = _counts(tuple(shape))
    b0, b1 = _threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 uniform on [minval, maxval) from the top 23 bits."""
    f32 = np.float32
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, as XLA computes it (Giles). Each
    polynomial step is a fused multiply-add, as XLA's CPU code contracts
    it: the product and sum in float64, rounded once to float32."""
    f32, f64 = np.float32, np.float64
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(np.float32)
    p = np.where(lt, f32(_ERFINV_W_LT_5[0]), f32(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = np.where(lt, f32(a), f32(b))
        p = (c.astype(f64) + p.astype(f64) * w.astype(f64)).astype(f32)
    out = p * x
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(np.float32).max,
                    out).astype(np.float32)


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in
    float32: a standard normal restricted to (lower, upper)."""
    f32 = np.float32
    sqrt2 = f32(np.sqrt(2))
    lo, up = f32(lower), f32(upper)
    a = f32(math.erf(float(lo / sqrt2)))
    b = f32(math.erf(float(up / sqrt2)))
    u = uniform(key, shape, a, b)
    out = sqrt2 * _erf_inv(u)
    return np.clip(out, np.nextafter(lo, f32(np.inf)),
                   np.nextafter(up, f32(-np.inf))).astype(np.float32)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` in ``int32``
    (bounds outside int32 raise, as the reference's do): two bit streams
    from a split key; the high one mod the span, times 2³² mod the span,
    plus the low one mod the span, mod the span — in uint32 arithmetic,
    which wraps where the reference's wraps."""
    lo, hi = np.int32(minval), np.int32(maxval)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    with np.errstate(over="ignore"):
        span = np.uint32(1) if hi <= lo else (hi - lo).astype(np.uint32)
        mult = np.uint32(2 ** 16) % span
        mult = mult * mult % span
        off = ((higher % span) * mult + lower % span) % span
        return lo + off.astype(np.int32)


def bernoulli(key: np.ndarray, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` (its default ``mode="low"``):
    a float32 :func:`uniform` below ``p`` rounded to float32."""
    return uniform(key, shape) < np.float32(p)


# ---------------------------------------------------------------------------
# the same draws on a device

_CHUNK = 1 << 24     # elements hashed at a time (bounds the temporaries)
_M32 = 0xFFFFFFFF


def _as_int32(v: int) -> int:
    """The uint32 value ``v`` (mod 2³²) as the int32 of the same bits."""
    return ((v + 2**31) & _M32) - 2**31


def _bits32_chunk(key: np.ndarray, start: int, n: int, device):
    """:func:`random_bits` of the flat indices [start, start + n) as an
    int32 tensor of the same bits: :func:`_threefry2x32` on int32, whose
    adds wrap as uint32's do; a right shift masks off the sign's copies."""
    import torch

    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (idx >> 32).to(torch.int32).add_(_as_int32(ks[0]))
    x1 = idx.to(torch.int32).add_(_as_int32(ks[1]))      # the low words
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            x1 = ((x1 << r) | (x1 >> (32 - r)).bitwise_and_((1 << r) - 1)) ^ x0
        x0.add_(_as_int32(ks[(i + 1) % 3]))
        x1.add_(_as_int32(ks[(i + 2) % 3] + i + 1))
    return x0 ^ x1


def _bits_chunk(key: np.ndarray, start: int, n: int, device):
    """:func:`random_bits` of the flat indices [start, start + n) as an
    int64 tensor of uint32 values."""
    import torch

    return _bits32_chunk(key, start, n, device).to(torch.int64).bitwise_and_(_M32)


def _fill(shape, dtype, device, chunk_fn):
    """A tensor of ``shape`` filled ``_CHUNK`` flat elements at a time by
    ``chunk_fn(start, n)``. On the meta device nothing is drawn: the
    tensor's shape and dtype are all there is."""
    import torch

    out = torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1)
    for a in range(0, flat.numel(), _CHUNK):
        n = min(_CHUNK, flat.numel() - a)
        flat[a:a + n] = chunk_fn(a, n)
    return out


def torch_random_bits(key: np.ndarray, shape, device):
    """:func:`random_bits` as an int64 tensor on ``device`` (values in
    [0, 2³²))."""
    import torch

    return _fill(shape, torch.int64, device,
                 lambda a, n: _bits_chunk(key, a, n, device))


def _uniform_chunk(key, start, n, lo, hi, device):
    """:func:`uniform`'s float32 steps on the bits of one chunk."""
    import torch

    bits = _bits32_chunk(key, start, n, device)
    floats = ((bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
              .view(torch.float32) - 1.0)
    lo_t = torch.tensor(lo, device=device)
    return torch.maximum(lo_t, floats * torch.tensor(hi - lo, device=device)
                         + lo_t)


def torch_uniform(key: np.ndarray, shape, device, minval=0.0, maxval=1.0):
    """:func:`uniform` as a float32 tensor on ``device``: the same bits and
    the same float32 operations, so the same values."""
    import torch

    lo, hi = np.float32(minval), np.float32(maxval)
    return _fill(shape, torch.float32, device,
                 lambda a, n: _uniform_chunk(key, a, n, lo, hi, device))


def torch_randint(key: np.ndarray, shape, minval: int, maxval: int, device):
    """:func:`randint` as an ``int32`` tensor on ``device``: the same two
    bit streams and the same uint32 arithmetic, wrapped by a mask in
    int64, so the same integers."""
    import torch

    lo, hi = int(np.int32(minval)), int(np.int32(maxval))
    span = 1 if hi <= lo else hi - lo
    # (2¹⁶ mod span)² wraps in uint32 before its own mod span, as the
    # reference's multiplier does
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    k1, k2 = split(key)

    def chunk(start, n):
        higher = _bits_chunk(k1, start, n, device)
        lower = _bits_chunk(k2, start, n, device)
        off = (higher.remainder_(span).mul_(mult).bitwise_and_(_M32)
               .add_(lower.remainder_(span)).bitwise_and_(_M32)
               .remainder_(span))
        return off.add_(lo)

    return _fill(shape, torch.int32, device, chunk)


def torch_bernoulli(key: np.ndarray, p: float, shape, device):
    """:func:`bernoulli` as a bool tensor on ``device``."""
    import torch

    p32 = float(np.float32(p))
    return _fill(shape, torch.bool, device,
                 lambda a, n: _uniform_chunk(key, a, n, np.float32(0.0),
                                             np.float32(1.0), device) < p32)


def _erf_inv_t(x):
    """:func:`_erf_inv` on a float32 tensor: the same polynomial, each
    step rounded once from float64 (a product of two float32 values is
    exact in float64, so ``addcmul`` fused or not gives the same sum)."""
    import torch

    f32 = lambda v: torch.tensor(np.float32(v), device=x.device)
    f64 = lambda v: torch.tensor(np.float64(np.float32(v)), device=x.device)
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - f32(2.5), torch.sqrt(w) - f32(3.0)).double()
    p = torch.where(lt, f32(_ERFINV_W_LT_5[0]), f32(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = torch.where(lt, f64(a), f64(b))
        p = torch.addcmul(c, p.double(), w).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * f32(np.finfo(np.float32).max),
                       p * x)


def torch_truncated_normal(key: np.ndarray, lower: float, upper: float,
                           shape, device, scale=None, dtype=None):
    """:func:`truncated_normal` as a float32 tensor on ``device``; with
    ``scale``, each draw times ``float32(scale)``, and with ``dtype``,
    cast to it. Both steps are elementwise and taken chunk by chunk, so a
    leaf of billions of weights never exists in float32 as a whole."""
    import torch

    f32 = np.float32
    sqrt2 = f32(np.sqrt(2))
    lo, up = f32(lower), f32(upper)
    a = f32(math.erf(float(lo / sqrt2)))
    b = f32(math.erf(float(up / sqrt2)))
    clip = (float(np.nextafter(lo, f32(np.inf))),
            float(np.nextafter(up, f32(-np.inf))))

    s = None if scale is None else torch.tensor(np.float32(scale), device=device)
    dtype = dtype or torch.float32

    def chunk(start, n):
        u = _uniform_chunk(key, start, n, a, b, device)
        z = (torch.tensor(sqrt2, device=device) * _erf_inv_t(u)).clamp_(*clip)
        return (z if s is None else s * z).to(dtype)

    return _fill(shape, dtype, device, chunk)
