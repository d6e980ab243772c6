"""SO(3) machinery for the port's equivariant GNNs (no e3nn dependency).

The twin of ``repro.models.gnn.so3``. Host (numpy, float64, cached):
complex Clebsch-Gordan via the Racah formula, the complex→real basis
transform U_l, real Wigner-D matrices, real CG coupling tensors — the
reference's own code, copied, so the tables are its bit for bit. On
tensors: real spherical harmonics via the associated-Legendre recursion,
and Wigner rotations assembled from the little-d factorial sum with the
host tables — the rotate-to-edge-frame primitive of the eSCN SO(2)
trick (EquiformerV2).

The tensor functions follow the reference's operations in its order and
compute in the dtype of their input (float32 as the reference does, or
float64): the host tables are cast to it. Where the reference writes
into a zero array with ``.at[].set``, the port assembles a fresh tensor
(stacked entries, padded blocks), so autograd never sees an in-place
write.

Conventions: complex SH with Condon-Shortley phase; real SH in the
standard (cos/sin) form; Y(R x) = D_real(R) Y(x).
"""
from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# host: complex CG (Racah), real-basis transform, real CG, real Wigner-D


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """⟨l1 m1 l2 m2 | l3 m3⟩ as [2l1+1, 2l2+1, 2l3+1] (float64)."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return out
    f = factorial
    pref_l = np.sqrt(
        (2 * l3 + 1)
        * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1)
    )
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref_m = np.sqrt(
                f(l3 + m3) * f(l3 - m3)
                * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2)
            )
            s = 0.0
            for k in range(0, l1 + l2 + l3 + 1):
                d1 = l1 + l2 - l3 - k
                d2 = l1 - m1 - k
                d3 = l2 + m2 - k
                d4 = l3 - l2 + m1 + k
                d5 = l3 - l1 - m2 + k
                if min(d1, d2, d3, d4, d5) < 0:
                    continue
                s += (-1) ** k / (f(k) * f(d1) * f(d2) * f(d3) * f(d4) * f(d5))
            out[m1 + l1, m2 + l2, m3 + l3] = pref_l * pref_m * s
    return out


@lru_cache(maxsize=None)
def _u_real(l: int) -> np.ndarray:
    """Complex→real change of basis: Y_real = U @ Y_complex (rows: real m)."""
    n = 2 * l + 1
    U = np.zeros((n, n), np.complex128)
    rt = 1.0 / np.sqrt(2.0)
    for m in range(-l, l + 1):
        r = m + l
        if m > 0:
            U[r, m + l] = (-1) ** m * rt
            U[r, -m + l] = rt
        elif m == 0:
            U[r, l] = 1.0
        else:
            am = -m
            U[r, am + l] = -1j * (-1) ** am * rt
            U[r, -am + l] = 1j * rt
    return U


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor [2l1+1, 2l2+1, 2l3+1].

    If T = (U1 ⊗ U2) G conj(U3)ᵀ is purely real it is returned directly;
    if purely imaginary its imaginary part is returned (both satisfy the
    equivariance identity when the D's are real orthogonal).
    """
    G = _cg_complex(l1, l2, l3)
    U1, U2, U3 = _u_real(l1), _u_real(l2), _u_real(l3)
    T = np.einsum("ac,bd,cde,fe->abf", U1, U2, G.astype(np.complex128),
                  np.conj(U3))
    re, im = np.real(T), np.imag(T)
    if np.abs(im).max() > np.abs(re).max():
        return np.ascontiguousarray(im)
    return np.ascontiguousarray(re)


def _little_d(l: int, beta: float) -> np.ndarray:
    """Wigner little-d d^l_{m'm}(β) (host float64, factorial sum)."""
    f = factorial
    d = np.zeros((2 * l + 1, 2 * l + 1))
    c, s = np.cos(beta / 2.0), np.sin(beta / 2.0)
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = np.sqrt(f(l + m) * f(l - m) * f(l + mp) * f(l - mp))
            tot = 0.0
            for k in range(max(0, m - mp), min(l + m, l - mp) + 1):
                num = (-1) ** (mp - m + k)
                den = f(l + m - k) * f(k) * f(l - mp - k) * f(mp - m + k)
                tot += num / den * c ** (2 * l + m - mp - 2 * k) * s ** (mp - m + 2 * k)
            d[mp + l, m + l] = pref * tot
    return d


def wigner_d_real_np(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Real-basis Wigner D for ZYZ Euler angles (host reference).

    Y(R x) = D Y(x) for R = Rz(α)Ry(β)Rz(γ): phases e^{+imα}, e^{+imγ}.
    """
    m = np.arange(-l, l + 1)
    Dc = (np.exp(1j * m[:, None] * alpha) * _little_d(l, beta)
          * np.exp(1j * m[None, :] * gamma))
    U = _u_real(l)
    D = U @ Dc @ np.conj(U).T
    if np.abs(D.imag).max() >= 1e-10:
        raise ArithmeticError(f"wigner_d_real_np({l}): D is not real")
    return D.real


# ---------------------------------------------------------------------------
# tensors: real spherical harmonics


def _legendre_all(l_max: int, x, one_m_x2):
    """P̂_l^m(x) (no Condon-Shortley) for 0≤m≤l≤l_max. Returns dict[(l,m)]."""
    P = {}
    sq = torch.sqrt(torch.clamp_min(one_m_x2, 0.0))
    for m in range(l_max + 1):
        if m == 0:
            pmm = torch.ones_like(x)
        else:
            pmm = P[(m - 1, m - 1)] * (2 * m - 1) * sq
        P[(m, m)] = pmm
        if m + 1 <= l_max:
            P[(m + 1, m)] = x * (2 * m + 1) * pmm
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * x * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def real_sph_harm(l_max: int, unit_vec: torch.Tensor) -> torch.Tensor:
    """Real orthonormal SH of unit vectors [..., 3] → [..., (l_max+1)²].

    Index layout: concatenated l-blocks, each ordered m = -l..l.
    """
    x, y, z = unit_vec[..., 0], unit_vec[..., 1], unit_vec[..., 2]
    ct = torch.clamp(z, -1.0, 1.0)
    one_m = torch.clamp_min(x * x + y * y, 0.0)
    phi = torch.atan2(y, x)
    P = _legendre_all(l_max, ct, one_m)
    blocks = []
    for l in range(l_max + 1):
        row = []
        for m in range(-l, l + 1):
            am = abs(m)
            k = np.sqrt((2 * l + 1) / (4 * np.pi)
                        * factorial(l - am) / factorial(l + am))
            if m == 0:
                row.append(float(k) * P[(l, 0)])
            elif m > 0:
                row.append(float(np.sqrt(2.0) * k) * torch.cos(m * phi)
                           * P[(l, m)])
            else:
                row.append(float(np.sqrt(2.0) * k) * torch.sin(am * phi)
                           * P[(l, am)])
        blocks.append(torch.stack(row, -1))
    return torch.cat(blocks, -1)


def irreps_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slices(l_max: int):
    out, off = [], 0
    for l in range(l_max + 1):
        out.append((off, off + 2 * l + 1))
        off += 2 * l + 1
    return out


# ---------------------------------------------------------------------------
# tensors: Wigner rotations assembled from precomputed constants


@lru_cache(maxsize=None)
def _littled_tables(l: int):
    """Static (prefactor, exponent) tables so d^l(β) is a device poly-eval.

    d[mp,m](β) = Σ_k coef · cos(β/2)^a · sin(β/2)^b — returns stacked
    (coef, a, b) arrays padded over k.
    """
    f = factorial
    n = 2 * l + 1
    kmax = 2 * l + 1
    coef = np.zeros((n, n, kmax))
    ca = np.zeros((n, n, kmax), np.int32)
    sb = np.zeros((n, n, kmax), np.int32)
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = np.sqrt(f(l + m) * f(l - m) * f(l + mp) * f(l - mp))
            for idx, k in enumerate(range(max(0, m - mp), min(l + m, l - mp) + 1)):
                num = (-1) ** (mp - m + k)
                den = f(l + m - k) * f(k) * f(l - mp - k) * f(mp - m + k)
                coef[mp + l, m + l, idx] = pref * num / den
                ca[mp + l, m + l, idx] = 2 * l + m - mp - 2 * k
                sb[mp + l, m + l, idx] = mp - m + 2 * k
    return coef, ca, sb


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def littled_device(l: int, beta: torch.Tensor) -> torch.Tensor:
    """d^l(β) on tensors: β [...] → [..., 2l+1, 2l+1]."""
    coef, ca, sb = _littled_tables(l)
    c = torch.cos(beta / 2.0)[..., None, None, None]
    s = torch.sin(beta / 2.0)[..., None, None, None]
    powers = torch.pow(c, _table(ca, c)) * torch.pow(s, _table(sb, s))
    return (_table(coef, c) * powers).sum(-1)


@lru_cache(maxsize=None)
def _u_parts(l: int):
    U = _u_real(l)
    return (np.ascontiguousarray(U.real.astype(np.float32)),
            np.ascontiguousarray(U.imag.astype(np.float32)))


def wigner_y_real(l: int, beta: torch.Tensor) -> torch.Tensor:
    """Real-basis D for a rotation about the y-axis: U d(β) U† (real part).

    U's parts are cast from float64 to β's dtype: in float32 they are
    :func:`_u_parts`, the reference's tables."""
    U = _u_real(l)
    A, B = _table(U.real, beta), _table(U.imag, beta)
    d = littled_device(l, beta)
    return (torch.einsum("ac,...cd,bd->...ab", A, d, A)
            + torch.einsum("ac,...cd,bd->...ab", B, d, B))


def rotz_real(l: int, alpha: torch.Tensor) -> torch.Tensor:
    """Real-basis D for a rotation about z: block 2×2 cos/sin mixing of ±m.

    The (−m, +m) real pair transforms with [[cos mα, sin mα], [−sin mα,
    cos mα]]. Built as a fresh tensor of stacked entries (the reference
    writes them into zeros with ``.at[].set``)."""
    n = 2 * l + 1
    zero = torch.zeros_like(alpha)
    rows = [[zero] * n for _ in range(n)]
    rows[l][l] = torch.ones_like(alpha)
    for m in range(1, l + 1):
        ca, sa = torch.cos(m * alpha), torch.sin(m * alpha)
        i_neg, i_pos = -m + l, m + l
        rows[i_neg][i_neg] = ca
        rows[i_neg][i_pos] = sa
        rows[i_pos][i_neg] = -sa
        rows[i_pos][i_pos] = ca
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotation_to_z(l: int, unit_vec: torch.Tensor) -> torch.Tensor:
    """Real D implementing the rotation that maps ``unit_vec`` to ẑ.

    R = Ry(−β) Rz(−α) with (α, β) the azimuth/polar angles of the vector;
    returns [..., 2l+1, 2l+1]. Apply as D @ features_l; inverse = Dᵀ.
    """
    x, y, z = unit_vec[..., 0], unit_vec[..., 1], unit_vec[..., 2]
    alpha = torch.atan2(y, x)
    beta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    return torch.einsum("...ab,...bc->...ac", wigner_y_real(l, -beta),
                        rotz_real(l, -alpha))


def rotation_to_z_full(l_max: int, unit_vec: torch.Tensor) -> torch.Tensor:
    """Block-diagonal D over all l ≤ l_max: [..., (L+1)², (L+1)²], the
    blocks padded to full rows and stacked (the reference writes them
    into zeros)."""
    n = irreps_dim(l_max)
    return torch.cat([F.pad(rotation_to_z(l, unit_vec), (a, n - b))
                      for l, (a, b) in enumerate(l_slices(l_max))], -2)
