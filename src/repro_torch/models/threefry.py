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
exactly.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["prng_key", "split", "random_bits", "uniform",
           "truncated_normal"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


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
