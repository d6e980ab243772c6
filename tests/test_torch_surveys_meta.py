"""The metadata surveys and SurveyBundle of the port vs the JAX package:
each survey's update, merge and finalize on numpy-seeded batches, the
ClosureTime float32 bins, the TopK tie-break, a bundle of all eight
built-ins through the entry points, pull_kernel="split" against "fused",
and the determinism stamp. Exact equality throughout (float32 included)."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import dodgr as ref_dodgr
from repro.core import engine as ref_engine
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.core.ref import count_triangles_ref, survey_triangles_ref
from repro_torch.graphs import csr as pt_csr
from repro_torch.graphs import generators as pt_gen
from repro_torch.interop import state_to_numpy
from test_torch_surveys import batch_fields, both_batches

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)


def ref_numpy(state):
    """A reference state as numpy, the same tree as state_to_numpy's."""
    if isinstance(state, dict):
        return {k: ref_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(ref_numpy(v) for v in state)
    return np.asarray(state)


def assert_tree_equal(ref, port):
    """Numpy trees equal leaf for leaf: structure, dtype and bits (NaN and
    -0.0 included)."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and ref.keys() == port.keys()
        for k in ref:
            assert_tree_equal(ref[k], port[k])
    elif isinstance(ref, (tuple, list)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for a, b in zip(ref, port):
            assert_tree_equal(a, b)
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape
        assert port.tobytes() == ref.tobytes()
    else:
        assert port == ref


def assert_states_equal(ref, port):
    assert_tree_equal(ref_numpy(ref), state_to_numpy(port))


def test_sort3_equals_reference():
    rng = np.random.default_rng(0)
    ints = rng.integers(-3, 4, (3, 500)).astype(np.int32)
    floats = rng.random((3, 500)).astype(np.float32)
    floats[:, ::7] = floats[0, ::7]                       # ties
    for x in (ints, floats):
        want = ref_sv._sort3(*map(jnp.asarray, x))
        got = pt_sv._sort3(*map(torch.as_tensor, x))
        for a, b in zip(want, got):
            assert b.numpy().tobytes() == np.asarray(a).tobytes()


def test_closure_bucket_equals_reference_float_sweep():
    """The 4,096 float32 neighbours on each side of every power of two from
    2⁰ to 2²⁰ (timestamps reach 1e6), and 100,000 random gaps in [0, 1e6]."""
    rng = np.random.default_rng(1)
    parts = [rng.random(100_000).astype(np.float32) * np.float32(1e6)]
    steps = np.arange(4097, dtype=np.float32)
    for k in range(21):
        p = np.float32(2.0**k)
        # float32 neighbours: ulp(p) above p, ulp(p) / 2 below it
        parts += [p + steps * np.spacing(p), p - steps[1:] * np.spacing(p / 2)]
    dt = np.concatenate(parts + [np.array([0.0, 0.5, 1.0], np.float32)])
    ref, port = ref_sv.ClosureTime(n_buckets=64), pt_sv.ClosureTime(n_buckets=64)
    want = np.asarray(ref._bucket(jnp.asarray(dt)))
    got = port._bucket(torch.as_tensor(dt)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[dt > 1] >= 1).all() and want.max() == 21


def _pairs(name):
    """(reference, port) instances of one survey at test size."""
    return {
        "LocalVertexCount": lambda m: m.LocalVertexCount(120),
        "ClosureTime": lambda m: m.ClosureTime(ts_col=1, n_buckets=12),
        "MaxEdgeLabelDist": lambda m: m.MaxEdgeLabelDist(6, e_label_col=1,
                                                         v_label_col=1),
        "LabelTripleSet": lambda m: m.LabelTripleSet(v_label_col=1, capacity=64),
        "LabelTripleSet_scatter": lambda m: m.LabelTripleSet(
            capacity=64, require_distinct=False, counting_backend="scatter"),
        "TopKWeightedTriangles": lambda m: m.TopKWeightedTriangles(7, weight_col=1),
        "Enumerate_wrap": lambda m: m.Enumerate(50, backend="pallas",
                                                pallas_interpret=True),
        "Enumerate": lambda m: m.Enumerate(2000),
        "SurveyBundle": lambda m: m.SurveyBundle(
            [m.LocalVertexCount(120), m.ClosureTime(ts_col=1, n_buckets=12),
             m.TopKWeightedTriangles(3)]),
        "SurveyBundle_solo": lambda m: m.SurveyBundle([m.MaxEdgeLabelDist(6)]),
    }[name]


def _batch(rng, B):
    """A batch whose ids stay in [0, 100) on valid lanes and are garbage on
    invalid ones; labels in [0, 6); float edge columns of gaps up to 1e6,
    with ties; NaN metadata on some invalid lanes."""
    w = dict(vp_i=2, vq_i=2, vr_i=2, e_pq_i=2, e_pr_i=2, e_qr_i=2,
             e_pq_f=2, e_pr_f=2, e_qr_f=2)
    f = batch_fields(rng, B, w)
    for k in ("vp_i", "vq_i", "vr_i", "e_pq_i", "e_pr_i", "e_qr_i"):
        f[k] = (f[k] % 6).astype(np.int32)
    for k in ("e_pq_f", "e_pr_f", "e_qr_f"):
        f[k] = (f[k] * np.float32(1e6)).astype(np.float32)
        f[k][::9] = np.float32(250.0)
    bad = ~f["valid"]
    for k in ("p", "q", "r"):
        f[k] = np.where(bad & (rng.random(B) < 0.3), rng.integers(-5, 500, B),
                        f[k]).astype(np.int32)
    nan_lanes = bad & (rng.random(B) < 0.2)
    f["e_pq_f"][nan_lanes] = np.nan
    return f


@pytest.mark.parametrize("name", [
    "LocalVertexCount", "ClosureTime", "MaxEdgeLabelDist", "LabelTripleSet",
    "LabelTripleSet_scatter", "TopKWeightedTriangles", "Enumerate_wrap",
    "Enumerate", "SurveyBundle", "SurveyBundle_solo"])
def test_survey_update_merge_finalize_equal_reference(name):
    """Two shards, three batches each: the state after every update, the
    merged state, merge_epochs, finalize and scale_sampled, bit for bit.
    Enumerate is held against the reference's Pallas ring (interpret) on a
    buffer that wraps, and against its default backend where it does
    not."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ref, port = _pairs(name)(ref_sv), _pairs(name)(pt_sv)
    rs, ps = [], []
    for _ in range(2):
        r_st, p_st = ref.init(), port.init("cpu")
        for _ in range(3):
            rb, pb = both_batches(_batch(rng, 300))
            r_st, p_st = ref.update(r_st, rb), port.update(p_st, pb)
            assert_states_equal(r_st, p_st)
        rs.append(r_st)
        ps.append(p_st)
    rm = ref.merge(jax.tree.map(lambda *x: jnp.stack(x), *rs))
    pm = port.merge(pt_engine.stack_states(ps))
    assert_states_equal(rm, pm)
    assert_states_equal(ref.merge_epochs(rm, rm), port.merge_epochs(pm, pm))
    want = ref.finalize(rm)
    assert_tree_equal(want, port.finalize(pm))
    assert_tree_equal(ref.scale_sampled(want, 0.5),
                      port.scale_sampled(port.finalize(pm), 0.5))
    if name == "Enumerate_wrap":
        assert want["overflowed"] > 0


def test_topk_all_tied_equals_reference():
    """Every weight ties, so the k survivors are decided by the (p, q, r)
    tie-break alone: the state after each update and the merge equal the
    reference's bit for bit (batches drawn with repeated keys, so whole
    rows tie too)."""
    rng = np.random.default_rng(11)
    ref, port = ref_sv.TopKWeightedTriangles(5), pt_sv.TopKWeightedTriangles(5)
    rs, ps = [], []
    for _ in range(2):
        r_st, p_st = ref.init(), port.init("cpu")
        for _ in range(3):
            f = batch_fields(rng, 200, dict(e_pq_f=1, e_pr_f=1, e_qr_f=1))
            for k in ("e_pq_f", "e_pr_f", "e_qr_f"):
                f[k][:] = np.float32(1.0)
            for k in ("p", "q", "r"):
                f[k] = rng.integers(0, 4, 200).astype(np.int32)
            rb, pb = both_batches(f)
            r_st, p_st = ref.update(r_st, rb), port.update(p_st, pb)
            assert_states_equal(r_st, p_st)
        rs.append(r_st)
        ps.append(p_st)
    rm = ref.merge(jax.tree.map(lambda *x: jnp.stack(x), *rs))
    pm = port.merge(pt_engine.stack_states(ps))
    assert_states_equal(rm, pm)
    assert (port.finalize(pm)["weights"] == 3.0).all()


def test_topk_tied_clique_is_transport_invariant():
    """A clique with unit edge weights through the engine: the k survivors
    are the k smallest triangles (p, q, r) on every transport, as the
    reference's test asserts of it."""
    k, n = 5, 7
    idx = np.arange(n)
    src, dst = np.meshgrid(idx, idx, indexing="ij")
    keep = src < dst
    g = pt_csr.HostGraph.from_edges(
        n, src[keep], dst[keep], spec=pt_csr.MetaSpec(e_float=("w",)),
        emeta_f=np.ones((int(keep.sum()), 1), np.float32))
    oracle = []
    survey_triangles_ref(g, lambda p, q, r, m: oracle.append((p, q, r)))
    gr, _ = pt_dodgr.shard_dodgr(g, 2, device="cpu")
    for tr in ("dense", "ragged"):
        survey = pt_sv.TopKWeightedTriangles(k)
        cfg, _ = pt_pp.plan_engine(g, 2, survey, mode="pushpull", push_cap=64,
                                   pull_q_cap=4, transport=tr)
        got, _ = pt_engine.survey_push_pull(gr, survey, cfg)
        assert (got["weights"] == 3.0).all()
        assert [tuple(t) for t in got["triangles"].tolist()] == sorted(oracle)[:k]


# ---------------------------------------------------------------------------
# a bundle of every built-in through the entry points


def labeled(gen, csr):
    """temporal_social(200, 2000) with the full-size deployment's columns:
    vertex int (label, degree), edge int tsbucket, edge float ts."""
    g = gen.temporal_social(200, 2000, seed=5)
    ts = g.emeta_f[:, 0]
    spec = csr.MetaSpec(v_int=g.spec.v_int, e_int=("tsbucket",),
                        e_float=g.spec.e_float)
    tsb = (ts / ts.max() * 15).astype(np.int32)
    g = csr.HostGraph(g.n, g.src, g.dst, spec, g.vmeta_i, g.vmeta_f,
                      tsb[:, None], g.emeta_f)
    return g.with_degree_meta()


def bundle(m, n):
    return m.SurveyBundle([
        m.TriangleCount(), m.LocalVertexCount(n), m.ClosureTime(ts_col=0),
        m.MaxEdgeLabelDist(16), m.DegreeTriples(deg_col=1, capacity=4096),
        m.LabelTripleSet(capacity=4096, counting_backend="scatter"),
        m.Enumerate(capacity=4096), m.TopKWeightedTriangles(k=8)])


class Bundles:
    """Graph, shards and reference bundle runs, built once per module."""

    def __init__(self):
        self.g = (labeled(ref_gen, ref_csr), labeled(pt_gen, pt_csr))
        self.gr = (ref_dodgr.shard_dodgr(self.g[0], 2)[0],
                   pt_dodgr.shard_dodgr(self.g[1], 2, device="cpu")[0])
        self.ref = {}

    def plan(self, mode, transport, **kw):
        kw = dict(mode=mode, push_cap=128, pull_q_cap=8, transport=transport, **kw)
        n = self.g[0].n
        rc, _ = ref_pp.plan_engine(self.g[0], 2, bundle(ref_sv, n), **kw)
        pc, _ = pt_pp.plan_engine(self.g[1], 2, bundle(pt_sv, n), **kw)
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        return rc, pc

    def ref_run(self, mode, transport):
        if (mode, transport) not in self.ref:
            rc, _ = self.plan(mode, transport)
            merged, stats = jax.jit(ref_engine.make_survey_fn(
                bundle(ref_sv, self.g[0].n), rc))(self.gr[0])
            self.ref[(mode, transport)] = (
                ref_numpy(merged), {k: float(v) for k, v in stats.items()},
                bundle(ref_sv, self.g[0].n).finalize(merged))
        return self.ref[(mode, transport)]


@pytest.fixture(scope="module")
def bundles():
    return Bundles()


@pytest.mark.parametrize("mode", ["push", "pushpull"])
@pytest.mark.parametrize("transport", ["dense", "ragged"])
def test_bundle_of_every_builtin_equals_reference(bundles, mode, transport):
    r_merged, r_stats, r_result = bundles.ref_run(mode, transport)
    _, pc = bundles.plan(mode, transport)
    survey = bundle(pt_sv, bundles.g[1].n)
    merged, stats = pt_engine.make_survey_fn(survey, pc)(bundles.gr[1])
    assert_tree_equal(r_merged, state_to_numpy(merged))
    assert stats == r_stats
    result = survey.finalize(merged)
    assert_tree_equal(r_result, result)
    t = count_triangles_ref(bundles.g[1])
    assert result["TriangleCount"] == t
    assert result["Enumerate"]["total_found"] == t
    assert result["LocalVertexCount"].sum() == 3 * t
    assert result["ClosureTime"]["joint"].sum() == t
    res, _ = pt_engine.survey_push_pull(bundles.gr[1], survey, pc) \
        if mode == "pushpull" else pt_engine.survey_push_only(bundles.gr[1], survey, pc)
    assert_tree_equal(r_result, res)


@pytest.mark.parametrize("transport", ["dense", "ragged"])
def test_split_pull_kernel_equals_fused(bundles, transport):
    """pull_kernel="split" (gathered candidates, reply rows padded back to
    L, intersect) gives the fused wedge_intersect's states and stats, and
    so the reference's."""
    r_merged, r_stats, _ = bundles.ref_run("pushpull", transport)
    _, pc = bundles.plan("pushpull", transport)
    assert 0 < pc.pull_row_cap < bundles.gr[1].d_plus_max   # rows get padded
    survey = bundle(pt_sv, bundles.g[1].n)
    merged, stats = pt_engine.make_survey_fn(
        survey, dataclasses.replace(pc, pull_kernel="split"))(bundles.gr[1])
    assert_tree_equal(r_merged, state_to_numpy(merged))
    assert stats == r_stats
    f_merged, f_stats = pt_engine.make_survey_fn(
        survey, dataclasses.replace(pc, pull_kernel="fused"))(bundles.gr[1])
    assert_tree_equal(state_to_numpy(f_merged), state_to_numpy(merged))
    assert f_stats == stats


def test_determinism_stamp_equals_reference():
    """The port's stamp for every built-in (Enumerate with both backends)
    and for a bundle of all eight is the reference's traced verdict."""
    spec = dict(v_int=("label", "degree"), e_int=("tsbucket",), e_float=("ts",))
    gs = [csr.HostGraph(5, g.src, g.dst, csr.MetaSpec(**spec))
          for csr, g in ((ref_csr, ref_gen.clique(5)), (pt_csr, pt_gen.clique(5)))]
    cases = [lambda m: m.TriangleCount(), lambda m: m.DegreeTriples(),
             lambda m: m.LocalVertexCount(5), lambda m: m.ClosureTime(),
             lambda m: m.MaxEdgeLabelDist(4), lambda m: m.LabelTripleSet(),
             lambda m: m.Enumerate(8), lambda m: m.Enumerate(8, backend="pallas"),
             lambda m: m.TopKWeightedTriangles(2), lambda m: bundle(m, 5)]
    for mk in cases:
        rc, _ = ref_pp.plan_engine(gs[0], 2, mk(ref_sv))
        pc, _ = pt_pp.plan_engine(gs[1], 2, mk(pt_sv))
        assert pc.determinism == rc.determinism == "bitwise", type(mk(pt_sv)).__name__
    assert pt_pp.plan_engine(gs[1], 2, pt_sv.MetaSpec.full())[0].determinism == \
        ref_pp.plan_engine(gs[0], 2, ref_sv.MetaSpec.full())[0].determinism
