"""The port's SO(3) machinery vs the JAX package's.

The host tables (complex and real Clebsch-Gordan, U_l, little-d, the
real Wigner-D, the little-d polynomial tables, U's float32 parts) are
the reference's code, copied: equal bit for bit. The tensor functions
(real spherical harmonics, little-d, the y and z rotations, the
rotation to ẑ per l and block-diagonal) on the same seeded unit vectors
for l ≤ 6 in float32 within ``RTOL`` / ``ATOL`` of the reference's
(float32 rounding: trigonometry, ``pow`` and the contractions are other
code). In float64 they meet the identities the reference's own tests
check: Y(R x) = D(R) Y(x) and D(x) Y(x) = Y(ẑ), to 1e-10.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import so3 as rs
from repro_torch.models.gnn import so3 as ps

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-6     # float32 tensors vs the reference's
L_MAX = 6


def unit_vectors(seed, n=64):
    """Seeded unit vectors, with the poles, the axes and a vector in the
    xy plane among them (atan2 and arccos at their edges)."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v = np.concatenate([v, [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
                            [-1, 0, 0], [1, 1, 0], [0, -1e-4, 1]]])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def close(ref, out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _rot(a, b, c):
    def Rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                         [0, 0, 1]])

    def Ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                         [-np.sin(t), 0, np.cos(t)]])

    return Rz(a) @ Ry(b) @ Rz(c)


LLL = [t for t in itertools.product(range(4), repeat=3)] + [
    (2, 2, 4), (3, 3, 6), (4, 3, 2), (5, 4, 3), (4, 4, 4)]


@pytest.mark.parametrize("name", ["_cg_complex", "cg_real"])
def test_clebsch_gordan_bit_for_bit(name):
    for lll in LLL:
        a, b = getattr(rs, name)(*lll), getattr(ps, name)(*lll)
        assert a.dtype == b.dtype and np.array_equal(a, b), lll


@pytest.mark.parametrize("name", ["_u_real", "_littled_tables", "_u_parts"])
def test_per_l_tables_bit_for_bit(name):
    for l in range(L_MAX + 1):
        a, b = getattr(rs, name)(l), getattr(ps, name)(l)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, l)


def test_wigner_d_and_little_d_bit_for_bit():
    rng = np.random.default_rng(3)
    for l in range(L_MAX + 1):
        for a, b, c in rng.uniform(-np.pi, 2 * np.pi, (4, 3)):
            assert np.array_equal(rs._little_d(l, b), ps._little_d(l, b))
            assert np.array_equal(rs.wigner_d_real_np(l, a, b, c),
                                  ps.wigner_d_real_np(l, a, b, c))


def test_irreps_dim_and_l_slices():
    for l in range(L_MAX + 3):
        assert ps.irreps_dim(l) == rs.irreps_dim(l)
        assert ps.l_slices(l) == rs.l_slices(l)


@pytest.mark.parametrize("l_max", [0, 1, 2, 3, L_MAX])
def test_real_sph_harm_equal_reference(l_max):
    v = unit_vectors(l_max)
    close(rs.real_sph_harm(l_max, jnp.asarray(v)),
          ps.real_sph_harm(l_max, torch.tensor(v)))


def test_little_d_and_axis_rotations_equal_reference():
    rng = np.random.default_rng(11)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, 40),
                          [0.0, np.pi, -np.pi, np.pi / 2]]).astype(np.float32)
    for l in range(L_MAX + 1):
        for name in ("littled_device", "wigner_y_real", "rotz_real"):
            fn = jax.jit(getattr(rs, name), static_argnums=0)
            close(fn(l, jnp.asarray(ang)),
                  getattr(ps, name)(l, torch.tensor(ang)))


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_rotation_to_z_equal_reference(l):
    v = unit_vectors(100 + l)
    close(rs.rotation_to_z(l, jnp.asarray(v)),
          ps.rotation_to_z(l, torch.tensor(v)))


def test_rotation_to_z_full_equal_reference():
    v = unit_vectors(7).reshape(-1, 1, 3)[:48].reshape(6, 8, 3)
    for l_max in (1, L_MAX):
        ref = jax.jit(rs.rotation_to_z_full, static_argnums=0)(
            l_max, jnp.asarray(v))
        out = ps.rotation_to_z_full(l_max, torch.tensor(v))
        assert tuple(out.shape) == ref.shape == (6, 8) + (ps.irreps_dim(l_max),) * 2
        close(ref, out)


def test_float64_identities():
    """In float64 the port's tensors meet the identities exactly enough
    to show they are the rotations they claim: Y(R x) = D(R) Y(x) with the
    host D, D(x) Y(x) = Y(ẑ), D orthogonal."""
    rng = np.random.default_rng(5)
    v = unit_vectors(5).astype(np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    R = _rot(a, b, c)
    Y = ps.real_sph_harm(L_MAX, torch.tensor(v)).numpy()
    Yr = ps.real_sph_harm(L_MAX, torch.tensor(v @ R.T)).numpy()
    z = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    Yz = ps.real_sph_harm(L_MAX, z).numpy()[0]
    D_full = ps.rotation_to_z_full(L_MAX, torch.tensor(v)).numpy()
    assert D_full.dtype == np.float64
    for l, (s0, s1) in enumerate(ps.l_slices(L_MAX)):
        D = ps.wigner_d_real_np(l, a, b, c)
        np.testing.assert_allclose(Yr[:, s0:s1], Y[:, s0:s1] @ D.T, atol=1e-10)
        Dz = D_full[:, s0:s1, s0:s1]
        np.testing.assert_allclose(np.einsum("nab,nb->na", Dz, Y[:, s0:s1]),
                                   np.tile(Yz[s0:s1], (len(v), 1)), atol=1e-10)
        np.testing.assert_allclose(np.einsum("nab,ncb->nac", Dz, Dz),
                                   np.tile(np.eye(s1 - s0), (len(v), 1, 1)),
                                   atol=1e-10)
