"""The search of the wedge_intersect CUDA kernel, modelled step for step on
the host, and ring_set's column interface, against the plain PyTorch
versions, the JAX package's Pallas kernels (interpret mode) and the
oracles. The inputs are shaped as the engine gives them: CSR key slots
whose candidate windows descend at vertex boundaries, rows with repeated
keys and (d, h) ties, windows clamped at both ends. The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py. Exact equality throughout."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.fold_scatter import ops as ref_fs
from repro.kernels.wedge_intersect import ops as ref_wi
from repro_torch.core import surveys as pt_sv
from repro_torch.kernels.fold_scatter import ops as fs
from repro_torch.kernels.fold_scatter.ref import ring_set_numpy
from repro_torch.kernels.wedge_intersect import ops as wi
from repro_torch.kernels.wedge_intersect.ref import (
    csr_shaped_inputs, wedge_intersect_lifting_numpy, wedge_intersect_numpy)
from test_torch_kernels import bits
from test_torch_kernels_meta import ring_inputs

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# wedge_intersect: binary lifting on (d, h), then the walk over id ties


def descents(kd, kh, ki, e, L):
    """Number of places a candidate window's key falls below the one
    before it, over all edges."""
    E = len(kd)
    idx = np.clip(e[:, None] + 1 + np.arange(L), 0, E - 1)
    key = list(zip(kd[idx].ravel().tolist(), kh[idx].ravel().tolist(),
                   ki[idx].ravel().tolist()))
    key = np.array(key, dtype=object).reshape(len(e), L, 3)
    return sum(tuple(key[b, k]) < tuple(key[b, k - 1])
               for b in range(len(e)) for k in range(1, L))


@pytest.mark.parametrize("E,B,Lr,L,bb", [
    (40, 30, 6, 7, 8),       # L below 32, not a multiple of 4
    (300, 40, 37, 50, 8),    # rows narrower than L
    (500, 24, 64, 29, 8),
    (200, 20, 45, 33, 32),   # rows wider than L
])
def test_wedge_intersect_lifting_model_equals_plain_and_pallas(E, B, Lr, L, bb):
    rng = np.random.default_rng(E + B + Lr + L)
    args = csr_shaped_inputs(rng, E, B, Lr, L)
    kd, kh, ki, e, rd, rh, ri, ln = args
    assert (ln == 0).any() and (ln == Lr).any()
    assert e.min() + 1 < 0 and e.max() + L > E - 1      # clamped both ends
    assert descents(kd, kh, ki, e, L) > 0
    pos, ci, ties = wedge_intersect_lifting_numpy(*args, L=L)
    assert ties > 0                 # the walk over (d, h) ties is taken
    t = [torch.as_tensor(kd), bits(kh), torch.as_tensor(ki), torch.as_tensor(e),
         torch.as_tensor(rd), bits(rh), torch.as_tensor(ri), torch.as_tensor(ln)]
    plain_pos, plain_ci = wi.wedge_intersect_plain(*t, L=L)
    np.testing.assert_array_equal(pos, plain_pos.numpy())
    np.testing.assert_array_equal(ci, plain_ci.numpy())
    want_pos, want_ci = ref_wi.wedge_intersect(*map(jnp.asarray, args), L=L,
                                               bb=bb, interpret=True)
    np.testing.assert_array_equal(pos, np.asarray(want_pos))
    np.testing.assert_array_equal(ci, np.asarray(want_ci))
    np_pos, np_ci = wedge_intersect_numpy(*args, L=L)
    np.testing.assert_array_equal(pos, np_pos)
    np.testing.assert_array_equal(ci, np_ci)


# ---------------------------------------------------------------------------
# ring_set: columns read where they lie


def wrap_or_one_slot(rng, B, cap, case):
    """Every lane on one slot, or a ring that wraps (more in-range lanes
    than cap, every fifth lane dropped at cap); rows are vertex ids."""
    slots = np.full(B, cap // 2) if case == "one_slot" else np.arange(B) % cap
    if case == "wrap":
        slots[::5] = cap
    rows = rng.integers(0, 2**31 - 1, (B, 3))
    prior = rng.integers(-1, 1000, (cap, 3))
    return (prior.astype(np.int32), slots.astype(np.int32), rows.astype(np.int32))


@pytest.mark.parametrize("B,cap,case", [
    (301, 64, "mixed"),        # B not a multiple of 4
    (202, 37, "one_slot"),
    (503, 64, "wrap"),
    (77, 1, "mixed"),          # capacity 1
    (45, 1, "wrap"),
    (60, 16, "none_valid"),
])
def test_ring_set_columns_equal_stacked_rows_and_pallas(B, cap, case):
    rng = np.random.default_rng(B * cap)
    if case in ("one_slot", "wrap"):
        prior, slots, rows = wrap_or_one_slot(rng, B, cap, case)
    else:
        prior, slots, rows = ring_inputs(rng, B, cap, case)
    tp, ts, tr = map(torch.as_tensor, (prior, slots, rows))
    stacked = fs.ring_set(tp, ts, tr, cap).numpy()
    for cols in (tr.unbind(1), tuple(c.contiguous() for c in tr.unbind(1)),
                 [c.contiguous() for c in tr.unbind(1)]):
        np.testing.assert_array_equal(fs.ring_set(tp, ts, cols, cap).numpy(),
                                      stacked)
    want = np.asarray(ref_fs.ring_set(jnp.asarray(prior), jnp.asarray(slots),
                                      jnp.asarray(rows), cap, bb=64,
                                      cap_tile=8, interpret=True))
    np.testing.assert_array_equal(stacked, want)
    np.testing.assert_array_equal(stacked, ring_set_numpy(prior, slots, rows, cap))


def test_enumerate_hands_ring_set_the_columns(monkeypatch):
    """Enumerate.update passes the batch's p, q, r columns to ring_set,
    unstacked."""
    seen = []
    real = fs.ring_set

    def spy(prior, slots, rows, capacity):
        seen.append(rows)
        return real(prior, slots, rows, capacity)

    monkeypatch.setattr(pt_sv.fs_ops, "ring_set", spy)
    survey = pt_sv.Enumerate(capacity=4)
    B = 6
    ids = torch.arange(3 * B, dtype=torch.int32).view(3, B)
    tri = pt_sv.TriangleBatch(
        p=ids[0], q=ids[1], r=ids[2],
        **{f: torch.zeros((B, 0), dtype=torch.float32 if f.endswith("_f")
                          else torch.int32)
           for f in ("vp_i", "vq_i", "vr_i", "vp_f", "vq_f", "vr_f", "e_pq_i",
                     "e_pr_i", "e_qr_i", "e_pq_f", "e_pr_f", "e_qr_f")},
        valid=torch.tensor([True, False, True, True, False, True]))
    state = survey.update(survey.init("cpu"), tri)
    assert isinstance(seen[0], tuple) and len(seen[0]) == 3
    assert all(c is x for c, x in zip(seen[0], (tri.p, tri.q, tri.r)))
    want = ring_set_numpy(np.full((4, 3), -1, np.int32),
                          np.array([0, 4, 1, 2, 4, 3], np.int32),
                          ids.T.numpy(), 4)
    np.testing.assert_array_equal(state["tris"].numpy(), want)
