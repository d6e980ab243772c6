"""The plain PyTorch versions of ring_set, intersect, hist_add and hist_max
vs the JAX package's Pallas kernels (interpret mode) and the oracles. On
the CPU the wrappers take the plain versions; the CUDA kernels themselves
are held against the plain versions on the card by chip_smoke.py. Exact
equality throughout."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.fold_scatter import ops as ref_fs
from repro.kernels.fold_scatter.ref import ring_set_ref
from repro.kernels.hist import ops as ref_hist
from repro.kernels.intersect import ops as ref_is
from repro.kernels.intersect.ref import intersect_numpy as ref_is_numpy
from repro_torch.kernels.fold_scatter import ops as fs
from repro_torch.kernels.fold_scatter.ref import ring_set_numpy
from repro_torch.kernels.hist import ops as hist
from repro_torch.kernels.hist.ref import hist_add_numpy, hist_max_numpy
from repro_torch.kernels.intersect import ops as isx
from repro_torch.kernels.intersect.ref import intersect_numpy
from test_torch_kernels import bits, sorted_keys

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# ring_set


def ring_inputs(rng, B, cap, case):
    """Contested slots (few distinct), slots -1 and ≥ cap, or a batch with
    no valid entry; rows are non-negative vertex ids."""
    if case == "contested":
        slots = rng.integers(0, max(1, cap // 4), B)
    elif case == "none_valid":
        slots = np.where(rng.random(B) < 0.5, -1, cap + rng.integers(0, 3, B))
    else:
        slots = rng.integers(-2, cap + 3, B)
        slots[::5] = -1
        slots[1::7] = cap
    rows = rng.integers(0, 2**31 - 1, (B, 3))
    prior = rng.integers(-1, 1000, (cap, 3))
    return (prior.astype(np.int32), slots.astype(np.int32), rows.astype(np.int32))


@pytest.mark.parametrize("B,cap,case", [(3, 8, "mixed"), (700, 64, "contested"),
                                        (300, 40, "mixed"), (50, 16, "none_valid")])
def test_ring_set_plain_equals_pallas(B, cap, case):
    rng = np.random.default_rng(B + cap)
    prior, slots, rows = ring_inputs(rng, B, cap, case)
    got = fs.ring_set(torch.as_tensor(prior), torch.as_tensor(slots),
                      torch.as_tensor(rows), cap).numpy()
    want = np.asarray(ref_fs.ring_set(jnp.asarray(prior), jnp.asarray(slots),
                                      jnp.asarray(rows), cap, bb=64,
                                      cap_tile=8, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(ring_set_ref(
        jnp.asarray(prior), jnp.asarray(slots), jnp.asarray(rows), cap)))
    np.testing.assert_array_equal(got, ring_set_numpy(prior, slots, rows, cap))
    if case == "none_valid":
        np.testing.assert_array_equal(got, prior)


# ---------------------------------------------------------------------------
# intersect


def isect_inputs(rng, B, L):
    """Sorted rows of length ln (some 0, some L) padded with the owner's
    sentinels; candidates drawn from the rows' keys or off them, with
    hashes ≥ 2³¹ common."""
    kd, kh, ki = sorted_keys(rng, 4 * L)
    ln = rng.integers(0, L + 1, B).astype(np.int32)
    ln[::4] = 0
    ln[1::4] = L
    rd = np.full((B, L), 2**30, np.int32)
    rh = np.full((B, L), 0xFFFFFFFF, np.uint32)
    ri = np.full((B, L), 2**30, np.int32)
    for b in range(B):
        sel = np.sort(rng.choice(4 * L, int(ln[b]), replace=False))
        rd[b, :ln[b]], rh[b, :ln[b]], ri[b, :ln[b]] = kd[sel], kh[sel], ki[sel]
    pick = rng.integers(0, 4 * L, (B, L))
    qd, qh, qi = kd[pick], kh[pick], ki[pick]
    qh[:, ::3] = rng.integers(2**31, 2**32, (B, L), dtype=np.uint64)[:, ::3].astype(np.uint32)
    return rd, rh, ri, ln, qd, qh, qi


@pytest.mark.parametrize("B,L,bb", [(4, 16, 8), (37, 33, 16), (64, 64, 32)])
def test_intersect_plain_equals_pallas(B, L, bb):
    rng = np.random.default_rng(B * L)
    rd, rh, ri, ln, qd, qh, qi = isect_inputs(rng, B, L)
    got = isx.intersect(torch.as_tensor(rd), bits(rh), torch.as_tensor(ri),
                        torch.as_tensor(ln), torch.as_tensor(qd), bits(qh),
                        torch.as_tensor(qi)).numpy()
    args = (rd, rh, ri, ln, qd, qh, qi)
    want = np.asarray(ref_is.intersect(*map(jnp.asarray, args), bb=bb,
                                       interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_is_numpy(*args))
    np.testing.assert_array_equal(got, intersect_numpy(*args))
    assert (got[::4] == 0).all() and (got <= ln[:, None]).all()


# ---------------------------------------------------------------------------
# hist_add, hist_max


def hist_inputs(rng, B, W, cap):
    slots = rng.integers(-3, cap + 3, B).astype(np.int32)
    slots[::7] = -1
    slots[1::9] = cap
    amounts = rng.integers(-2, 5, B).astype(np.int32)
    rows = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    rows[::5] = 0
    return slots, amounts, rows


@pytest.mark.parametrize("B,W,cap,bb,ct", [(5, 1, 8, 8, 8), (1000, 5, 512, 256, 256),
                                           (300, 3, 64, 64, 16)])
def test_hist_plain_equals_pallas_and_fold_count_max(B, W, cap, bb, ct):
    rng = np.random.default_rng(B + W + cap)
    slots, amounts, rows = hist_inputs(rng, B, W, cap)
    ts, ta, tr = torch.as_tensor(slots), torch.as_tensor(amounts), bits(rows)
    count = hist.hist_add(ts, ta, cap).numpy()
    packed = u32(hist.hist_max(ts, tr, cap))
    np.testing.assert_array_equal(count, np.asarray(ref_hist.hist_add(
        jnp.asarray(slots), jnp.asarray(amounts), cap, bb=bb, cap_tile=ct,
        interpret=True)))
    np.testing.assert_array_equal(packed, np.asarray(ref_hist.hist_max(
        jnp.asarray(slots), jnp.asarray(rows), cap, bb=bb, cap_tile=ct,
        interpret=True)))
    np.testing.assert_array_equal(count, hist_add_numpy(slots, amounts, cap))
    np.testing.assert_array_equal(packed, hist_max_numpy(slots, rows, cap))
    f_count, f_packed = fs.fold_count_max(ts, ta, tr, cap)
    np.testing.assert_array_equal(f_count.numpy(), count)
    np.testing.assert_array_equal(u32(f_packed), packed)


# ---------------------------------------------------------------------------
# the device alone picks kernel versus plain


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (fs.ring_set_launches, isx.launches, hist.hist_add_launches,
              hist.hist_max_launches)
    s = torch.tensor([0, 1, -1, 4], dtype=torch.int32)
    rows = s.abs()[:, None].expand(-1, 3).contiguous()
    assert torch.equal(fs.ring_set(rows, s, rows, 4),
                       fs.ring_set_plain(rows, s, rows, 4))
    assert torch.equal(hist.hist_add(s, s, 4), hist.hist_add_plain(s, s, 4))
    assert torch.equal(hist.hist_max(s, rows, 4), hist.hist_max_plain(s, rows, 4))
    q = torch.zeros((4, 3), dtype=torch.int32)
    assert torch.equal(isx.intersect(q, q, q, s.abs(), q, q, q),
                       isx.intersect_plain(q, q, q, s.abs(), q, q, q))
    assert (fs.ring_set_launches, isx.launches, hist.hist_add_launches,
            hist.hist_max_launches) == before


class _Elsewhere:
    """A tensor stand-in on a device no wrapper has a route for (meta has
    one: the kernel's output shapes)."""

    device = torch.device("xla")

    def __getitem__(self, _):
        return self


def test_other_devices_raise():
    m = m3 = _Elsewhere()
    with pytest.raises(ValueError, match="unsupported device"):
        fs.ring_set(m3, m, m3, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        isx.intersect(m3, m3, m3, m, m3, m3, m3)
    with pytest.raises(ValueError, match="unsupported device"):
        hist.hist_add(m, m, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        hist.hist_max(m, m3, 4)
