"""Port ShardedDODGr vs the JAX package's shard_dodgr, field by field,
and the interop round trip. Exact equality throughout."""
import dataclasses

import numpy as np
import torch
import pytest

from repro.core import dodgr as ref_dodgr
from repro.graphs import generators as ref_gen
from repro_torch import interop
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.graphs import generators as pt_gen

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

GRAPHS = {
    "clique8": lambda gen: gen.clique(8),
    "karate": lambda gen: gen.karate(),
    "rmat7": lambda gen: gen.rmat(7, 8, seed=1),
    "er": lambda gen: gen.erdos_renyi(150, 900, seed=2),
    "social": lambda gen: gen.temporal_social(120, 1200, seed=4),
}

ARRAY_FIELDS = pt_dodgr.PER_SHARD_FIELDS + pt_dodgr.REPLICATED_FIELDS


def ref_arrays(gr):
    return ({f: np.asarray(getattr(gr, f)) for f in ARRAY_FIELDS},
            {f: getattr(gr, f) for f in pt_dodgr.META_FIELDS})


def assert_shards_equal(ref_gr, port_gr):
    want, want_meta = ref_arrays(ref_gr)
    got, got_meta = interop.shards_to_arrays(port_gr)
    assert got_meta == want_meta
    for f in ARRAY_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def assert_routing_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_shard_fields_equal_reference(name, S):
    g_ref = GRAPHS[name](ref_gen).with_degree_meta()
    g_pt = GRAPHS[name](pt_gen).with_degree_meta()
    ref_gr, ref_rs = ref_dodgr.shard_dodgr(g_ref, S)
    pt_gr, pt_rs = pt_dodgr.shard_dodgr(g_pt, S, device="cpu")
    assert_shards_equal(ref_gr, pt_gr)
    assert_routing_equal(ref_rs, pt_rs)


@pytest.mark.parametrize("kw", [
    dict(hub_theta=6), dict(cap_policy="bucket"), dict(orient="stable"),
    dict(sample_p=0.5, sample_seed=3), dict(e_cap_floor=4000, d_plus_max_floor=70),
], ids=["hub", "bucket", "stable", "sampled", "floors"])
def test_shard_options_equal_reference(kw):
    g_ref = ref_gen.temporal_social(120, 1200, seed=4)
    g_pt = pt_gen.temporal_social(120, 1200, seed=4)
    ref_gr, ref_rs = ref_dodgr.shard_dodgr(g_ref, 4, **kw)
    pt_gr, pt_rs = pt_dodgr.shard_dodgr(g_pt, 4, device="cpu", **kw)
    assert_shards_equal(ref_gr, pt_gr)
    assert_routing_equal(ref_rs, pt_rs)


def test_host_helpers_equal_reference():
    g_ref = ref_gen.rmat(7, 8, seed=1)
    g_pt = pt_gen.rmat(7, 8, seed=1)
    for orient in ("degree", "stable"):
        for a, b in zip(ref_dodgr.orient_edges(g_ref, orient),
                        pt_dodgr.orient_edges(g_pt, orient)):
            np.testing.assert_array_equal(a, b)
    s_ref = ref_dodgr.sparsify_edges(g_ref, 0.3, seed=5)
    s_pt = pt_dodgr.sparsify_edges(g_pt, 0.3, seed=5)
    np.testing.assert_array_equal(s_ref.src, s_pt.src)
    assert (s_ref.sample_p, s_ref.sample_seed) == (s_pt.sample_p, s_pt.sample_seed)
    assert ref_dodgr.meta_widths(1, 2, 3, 4, 5, 6) == pt_dodgr.meta_widths(1, 2, 3, 4, 5, 6)
    assert ref_dodgr.hub_widths(1, 2, 3, 4, True) == pt_dodgr.hub_widths(1, 2, 3, 4, True)
    rng = np.random.default_rng(0)
    q = rng.integers(0, 50, 40)
    row_len = np.array([10, 5, 25])
    row_start = np.array([0, 10, 15])
    new = rng.random(40) < 0.2
    touched = rng.random(50) < 0.3
    np.testing.assert_array_equal(
        ref_dodgr.delta_gen_mask(q, row_start, row_len, new, touched),
        pt_dodgr.delta_gen_mask(q, row_start, row_len, new, touched))


def test_interop_round_trip_is_identity():
    g_ref = ref_gen.karate().with_degree_meta()
    ref_gr, _ = ref_dodgr.shard_dodgr(g_ref, 4, hub_theta=8)
    arrays, meta = ref_arrays(ref_gr)
    carried = interop.shards_from_arrays(arrays, meta, "cpu")
    assert_shards_equal(ref_gr, carried)
    back, back_meta = interop.shards_to_arrays(carried)
    assert back_meta == meta
    for f in ARRAY_FIELDS:
        assert back[f].dtype == arrays[f].dtype
        np.testing.assert_array_equal(back[f], arrays[f])
    with pytest.raises(KeyError, match="nbr_h"):
        interop.shards_from_arrays({k: v for k, v in arrays.items()
                                    if k != "nbr_h"}, meta, "cpu")
