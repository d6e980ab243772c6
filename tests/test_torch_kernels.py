"""The three ported kernels' plain PyTorch versions vs the JAX package's
Pallas kernels (interpret mode) and the oracles. On the CPU the wrappers
take the plain versions; the CUDA kernels themselves are held against the
plain versions on the card by chip_smoke.py. Exact equality throughout."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.fold_scatter import ops as ref_fs
from repro.kernels.fold_scatter.ref import fold_count_max_ref
from repro.kernels.wedge_check import ops as ref_wc
from repro.kernels.wedge_check.ref import lower_bound_numpy as ref_lb_numpy
from repro.kernels.wedge_intersect import ops as ref_wi
from repro.kernels.wedge_intersect.ref import wedge_intersect_numpy as ref_wi_numpy
from repro_torch.kernels.fold_scatter import ops as fs
from repro_torch.kernels.fold_scatter.ref import fold_count_max_numpy
from repro_torch.kernels.wedge_check import ops as wc
from repro_torch.kernels.wedge_check.ref import lower_bound_numpy
from repro_torch.kernels.wedge_intersect import ops as wi
from repro_torch.kernels.wedge_intersect.ref import wedge_intersect_numpy

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)


def bits(a):
    """uint32 numpy → int32 tensor holding the same bits."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.uint32).view(np.int32)))


def sorted_keys(rng, n):
    """(d, h, id) keys sorted by the total order; a quarter of the hashes
    sit on the 2³⁰ grid so ties and hashes ≥ 2³¹ are common."""
    d = rng.integers(0, 5, n).astype(np.int32)
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    h[: n // 4] = rng.integers(0, 4, n // 4).astype(np.uint32) << np.uint32(30)
    i = rng.permutation(n).astype(np.int32)
    order = np.lexsort((i, h, d))
    return d[order], h[order], i[order]


# ---------------------------------------------------------------------------
# wedge_check


@pytest.mark.parametrize("S,E,B,bq", [(1, 8, 3, 8), (2, 64, 33, 8),
                                      (3, 300, 1000, 128)])
def test_wedge_check_plain_equals_pallas(S, E, B, bq):
    rng = np.random.default_rng(E + B)
    keys = [sorted_keys(rng, E) for _ in range(S)]
    lo = rng.integers(0, E + 1, (S, B)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, E, (S, B)), E).astype(np.int32)
    hi[:, ::4] = lo[:, ::4]                                   # empty rows
    pick = rng.integers(0, E, (S, B))
    qd = np.stack([k[0][p] for k, p in zip(keys, pick)])
    qh = np.stack([k[1][p] for k, p in zip(keys, pick)])
    qi = np.stack([k[2][p] for k, p in zip(keys, pick)])
    qi[:, ::3] = rng.integers(0, E, (S, B))[:, ::3]
    qh[:, 1::5] = rng.integers(2**31, 2**32, (S, B), dtype=np.uint64)[:, 1::5].astype(np.uint32)
    got = wc.wedge_check(
        torch.as_tensor(np.stack([k[0] for k in keys])),
        bits(np.stack([k[1] for k in keys])),
        torch.as_tensor(np.stack([k[2] for k in keys])),
        torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(qd),
        bits(qh), torch.as_tensor(qi)).numpy()
    for s in range(S):
        kd, kh, ki = keys[s]
        args = (kd, kh, ki, lo[s], hi[s], qd[s], qh[s], qi[s])
        want = np.asarray(ref_wc.wedge_check(*map(jnp.asarray, args), bq=bq,
                                             interpret=True))
        np.testing.assert_array_equal(got[s], want)
        np.testing.assert_array_equal(got[s], ref_lb_numpy(*args))
        np.testing.assert_array_equal(got[s], lower_bound_numpy(*args))


# ---------------------------------------------------------------------------
# wedge_intersect


def intersect_inputs(rng, E, B, Lr):
    kd, kh, ki = sorted_keys(rng, E)
    e = rng.integers(-2, E + 2, B).astype(np.int32)
    ln = rng.integers(0, Lr + 1, B).astype(np.int32)
    ln[::4] = 0                                               # empty rows
    rd = np.full((B, Lr), 2**30, np.int32)
    rh = np.full((B, Lr), 0xFFFFFFFF, np.uint32)
    ri = np.full((B, Lr), 2**30, np.int32)
    for b in range(B):
        n = int(ln[b])
        sel = np.sort(rng.choice(E, n, replace=False))
        rd[b, :n], rh[b, :n], ri[b, :n] = kd[sel], kh[sel], ki[sel]
    return kd, kh, ki, e, rd, rh, ri, ln


@pytest.mark.parametrize("E,B,Lr,L,bb", [(16, 5, 4, 9, 8), (64, 37, 12, 12, 8),
                                         (200, 70, 20, 33, 32)])
def test_wedge_intersect_plain_equals_pallas(E, B, Lr, L, bb):
    rng = np.random.default_rng(E * B + L)
    kd, kh, ki, e, rd, rh, ri, ln = intersect_inputs(rng, E, B, Lr)
    pos, ci = wi.wedge_intersect(
        torch.as_tensor(kd), bits(kh), torch.as_tensor(ki), torch.as_tensor(e),
        torch.as_tensor(rd), bits(rh), torch.as_tensor(ri), torch.as_tensor(ln),
        L=L)
    args = (kd, kh, ki, e, rd, rh, ri, ln)
    want_pos, want_ci = ref_wi.wedge_intersect(*map(jnp.asarray, args), L=L,
                                               bb=bb, interpret=True)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(ci.numpy(), np.asarray(want_ci))
    np_pos, np_ci = ref_wi_numpy(*args, L=L)
    np.testing.assert_array_equal(pos.numpy(), np_pos)
    port_pos, port_ci = wedge_intersect_numpy(*args, L=L)
    np.testing.assert_array_equal(pos.numpy(), port_pos)
    np.testing.assert_array_equal(ci.numpy(), port_ci)


# ---------------------------------------------------------------------------
# fold_count_max


@pytest.mark.parametrize("B,W,cap,bb", [(3, 5, 8, 8), (1001, 5, 64, 256),
                                        (300, 2, 7, 64)])
def test_fold_count_max_plain_equals_pallas(B, W, cap, bb):
    rng = np.random.default_rng(B + cap)
    slots = rng.integers(-3, cap + 3, B).astype(np.int32)
    slots[::7] = -1
    slots[1::9] = cap
    amounts = rng.integers(0, 4, B).astype(np.int32)
    rows = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    rows[::5] = 0
    count, packed = fs.fold_count_max(torch.as_tensor(slots),
                                      torch.as_tensor(amounts), bits(rows), cap)
    packed = packed.numpy().view(np.uint32)
    want_c, want_p = ref_fs.fold_count_max(
        jnp.asarray(slots), jnp.asarray(amounts), jnp.asarray(rows), cap,
        bb=bb, interpret=True)
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(packed, np.asarray(want_p))
    ref_c, ref_p = fold_count_max_ref(jnp.asarray(slots), jnp.asarray(amounts),
                                      jnp.asarray(rows), cap)
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(packed, np.asarray(ref_p))
    np_c, np_p = fold_count_max_numpy(slots, amounts, rows, cap)
    np.testing.assert_array_equal(count.numpy(), np_c)
    np.testing.assert_array_equal(packed, np_p)


# ---------------------------------------------------------------------------
# the device alone picks kernel versus plain


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(3)
    before = (wc.launches, wi.launches, fs.launches)
    kd, kh, ki, e, rd, rh, ri, ln = intersect_inputs(rng, 40, 6, 5)
    t = [torch.as_tensor(kd), bits(kh), torch.as_tensor(ki), torch.as_tensor(e),
         torch.as_tensor(rd), bits(rh), torch.as_tensor(ri), torch.as_tensor(ln)]
    a = wi.wedge_intersect(*t, L=7)
    b = wi.wedge_intersect_plain(*t, L=7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    s = torch.tensor([0, 1, -1], dtype=torch.int32)
    fs.fold_count_max(s, s.abs(), s[:, None].abs(), 4)
    assert (wc.launches, wi.launches, fs.launches) == before


class _Elsewhere:
    """A tensor stand-in on a device no wrapper has a route for (meta has
    one: the kernel's output shapes)."""

    device = torch.device("xla")

    def __getitem__(self, _):
        return self


def test_other_devices_raise():
    m = _Elsewhere()
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fold_count_max(m, m, m[:, None], 4)
    with pytest.raises(ValueError, match="unsupported device"):
        wc.wedge_check(m[None], m[None], m[None], m[None], m[None], m[None],
                       m[None], m[None])
    with pytest.raises(ValueError, match="unsupported device"):
        wi.wedge_intersect(m, m, m, m, m[:, None], m[:, None], m[:, None], m, L=2)
