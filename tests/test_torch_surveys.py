"""Port surveys, counting set and lane helpers vs the JAX package, on
random batches made with numpy. Exact equality throughout."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import counting_set as ref_cs
from repro.core import surveys as ref_sv
from repro_torch.core import counting_set as pt_cs
from repro_torch.core import surveys as pt_sv
from repro_torch.interop import state_to_numpy

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)


def jnp_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def assert_states_equal(ref, port):
    ref, port = jnp_state(ref), state_to_numpy(port)
    assert ref.keys() == port.keys()
    for k in ref:
        assert ref[k].dtype == port[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_lg_equals_reference_up_to_2_pow_21():
    d = np.concatenate([np.arange(-3, (1 << 21) + 1),
                        [(1 << k) + o for k in range(21) for o in (-1, 0, 1)]]
                       ).astype(np.int32)
    ref = np.asarray(ref_sv.DegreeTriples()._lg(jnp.asarray(d)))
    port = pt_sv.DegreeTriples()._lg(torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_lg_follows_reference_float32_rounding_above_2_pow_21():
    """Above 2²¹ the reference's float32 ceil(log2) rounds down just past
    each power of two (2²¹ + 1 gives 21); the port bins the same way. The
    sweep covers ±4096 around every power of two from 2²¹, the top of
    int32, and random degrees."""
    rng = np.random.default_rng(0)
    near = [(1 << k) + np.arange(-4096, 4097) for k in range(21, 31)]
    d = np.concatenate(near + [np.arange(2**31 - 4096, 2**31),
                               rng.integers(1 << 21, 2**31, 100_000)]
                       ).astype(np.int32)
    ref = np.asarray(ref_sv.DegreeTriples()._lg(jnp.asarray(d)))
    port = pt_sv.DegreeTriples()._lg(torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(port, ref)
    exact = np.ceil(np.log2(d.astype(np.float64))).astype(np.int32)
    rounded_down = d[ref < exact]
    assert (1 << 21) + 2 in rounded_down and (1 << 25) + 50 in rounded_down


@pytest.mark.parametrize("backend", ["scatter", "pallas"])
def test_counting_set_equals_reference(backend):
    rng = np.random.default_rng(7 if backend == "scatter" else 8)
    cap, B, S = 64, 300 if backend == "scatter" else 40, 3
    ref = ref_cs.CountingSet(cap, 3, backend=backend, pallas_interpret=True)
    port = pt_cs.CountingSet(cap, 3, backend=backend)
    ref_states, port_states = [], []
    for _ in range(S):
        rs, ps = ref.init(), port.init("cpu")
        for _ in range(2):
            keys = rng.integers(-4, 5, (B, 3)).astype(np.int32)
            keys[::9, 0] = 2**31 - 1
            keys[1::9, 1] = -(2**31)
            valid = rng.random(B) < 0.7
            rs = ref.increment(rs, jnp.asarray(keys), jnp.asarray(valid))
            ps = port.increment(ps, torch.as_tensor(keys), torch.as_tensor(valid))
            assert_states_equal(rs, ps)
        ref_states.append(rs)
        port_states.append(ps)
    stack = lambda sts, f: {k: f([s[k] for s in sts]) for k in sts[0]}
    rm = ref.merge(stack(ref_states, jnp.stack))
    pm = port.merge(stack(port_states, torch.stack))
    assert_states_equal(rm, pm)
    assert_states_equal(ref.merge_epochs(rm, ref_states[0]),
                        port.merge_epochs(pm, port_states[0]))
    assert port.finalize(pm) == ref.finalize(rm)


def batch_fields(rng, B, widths):
    out = dict(p=rng.integers(0, 100, B), q=rng.integers(0, 100, B),
               r=rng.integers(0, 100, B), valid=rng.random(B) < 0.6)
    for f in ("vp_i", "vq_i", "vr_i", "e_pq_i", "e_pr_i", "e_qr_i"):
        out[f] = rng.integers(0, 3000, (B, widths.get(f, 0))).astype(np.int32)
    for f in ("vp_f", "vq_f", "vr_f", "e_pq_f", "e_pr_f", "e_qr_f"):
        out[f] = rng.random((B, widths.get(f, 0))).astype(np.float32)
    for f in ("p", "q", "r"):
        out[f] = out[f].astype(np.int32)
    return out


def both_batches(fields):
    ref = ref_sv.TriangleBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    port = pt_sv.TriangleBatch(**{k: torch.as_tensor(v) for k, v in fields.items()})
    return ref, port


def test_degree_triples_update_merge_finalize_equal_reference():
    rng = np.random.default_rng(1)
    ref, port = ref_sv.DegreeTriples(capacity=128), pt_sv.DegreeTriples(capacity=128)
    rs, ps = [], []
    for s in range(2):
        r_st, p_st = ref.init(), port.init("cpu")
        for _ in range(3):
            f = batch_fields(rng, 500, dict(vp_i=1, vq_i=1, vr_i=1))
            f["vq_i"][::7] = 1 << np.arange(len(f["vq_i"][::7]))[:, None] % 12
            rb, pb = both_batches(f)
            r_st, p_st = ref.update(r_st, rb), port.update(p_st, pb)
            assert_states_equal(r_st, p_st)
        rs.append(r_st)
        ps.append(p_st)
    rm = ref.merge({k: jnp.stack([s[k] for s in rs]) for k in rs[0]})
    pm = port.merge({k: torch.stack([s[k] for s in ps]) for k in ps[0]})
    assert_states_equal(rm, pm)
    assert port.finalize(pm) == ref.finalize(rm)
    assert port.scale_sampled(port.finalize(pm), 0.5) == \
        ref.scale_sampled(ref.finalize(rm), 0.5)


def test_triangle_count_limbs_equal_reference_across_wraps():
    rng = np.random.default_rng(2)
    ref, port = ref_sv.TriangleCount(), pt_sv.TriangleCount()
    start = np.array([2**32 - 5, 2**32 - 1, 7], np.uint32)
    rs, ps = [], []
    for lo in start:
        r_st = dict(lo=jnp.uint32(lo), hi=jnp.uint32(3))
        p_st = dict(lo=torch.tensor(int(lo) - 2**32 if lo >= 2**31 else int(lo),
                                    dtype=torch.int32),
                    hi=torch.tensor(3, dtype=torch.int32))
        for _ in range(3):
            rb, pb = both_batches(batch_fields(rng, 50, {}))
            r_st, p_st = ref.update(r_st, rb), port.update(p_st, pb)
            assert_states_equal(r_st, p_st)
        rs.append(r_st)
        ps.append(p_st)
    rm = ref.merge({k: jnp.stack([s[k] for s in rs]) for k in rs[0]})
    pm = port.merge({k: torch.stack([s[k] for s in ps]) for k in ps[0]})
    assert_states_equal(rm, pm)
    assert port.finalize(pm) == ref.finalize(rm)
    assert_states_equal(ref.merge_epochs(rm, rs[0]), port.merge_epochs(pm, ps[0]))


def test_meta_spec_and_lane_helpers_equal_reference():
    specs = [
        (ref_sv.MetaSpec.vertices(i=(1,)) | ref_sv.MetaSpec.edges(f=(0, 2)),
         pt_sv.MetaSpec.vertices(i=(1,)) | pt_sv.MetaSpec.edges(f=(0, 2))),
        (ref_sv.MetaSpec.full(), pt_sv.MetaSpec.full()),
        (ref_sv.MetaSpec.none(), pt_sv.MetaSpec.none()),
    ]
    rng = np.random.default_rng(4)
    x = rng.integers(0, 9, (4, 5, 3)).astype(np.int32)
    for rs, ps in specs:
        rr, pr = rs.resolve(3, 1, 2, 3), ps.resolve(3, 1, 2, 3)
        assert dataclasses.asdict(rr) == dataclasses.asdict(pr)
        assert rr.lane_counts() == pr.lane_counts()
        for lanes in (pr.vp_i, pr.e_pq_f, (0, 2), (1,), ()):
            for fn in ("project_lanes", "narrow_lanes"):
                got = getattr(pt_sv, fn)(torch.as_tensor(x), lanes).numpy()
                want = np.asarray(getattr(ref_sv, fn)(jnp.asarray(x), lanes))
                np.testing.assert_array_equal(got, want)
            w = np.array(ref_sv.project_lanes(jnp.asarray(x), lanes))
            np.testing.assert_array_equal(
                pt_sv.expand_lanes(torch.as_tensor(w), lanes).numpy(),
                np.asarray(ref_sv.expand_lanes(jnp.asarray(w), lanes)))
    with pytest.raises(ValueError, match="declares lanes"):
        pt_sv.MetaSpec.vertices(i=(4,)).resolve(3, 1, 2, 3)
