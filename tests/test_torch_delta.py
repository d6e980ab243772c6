"""The port's delta epochs vs the JAX package's, at test_delta.py's sizes:
append_edges, the frontier and the npz files across packages; plan_delta's
configs, reports and tokens; K = 4 timestamp-ordered batches of a bundle of
seven built-ins through survey_delta in push and push-pull, whose states,
stats and finalized results equal the reference's after every epoch and
the port's own one-shot stable-key survey at the end; the provenance
guards; and the order_sensitive warning. Exact equality throughout
(float32 included). The reference runs are shared through a module
fixture."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import dodgr as ref_dodgr
from repro.core import engine as ref_engine
from repro.core import pushpull as ref_pp
from repro.core import ref as ref_oracle
from repro.core import surveys as ref_sv
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro.graphs import io as ref_io
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import ref as pt_oracle
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import csr as pt_csr
from repro_torch.graphs import generators as pt_gen
from repro_torch.graphs import io as pt_io
from repro_torch.interop import state_to_numpy
from test_torch_contracts import PtFloatAdd, RefFloatAdd
from test_torch_dodgr import assert_shards_equal
from test_torch_surveys_meta import assert_tree_equal, ref_numpy

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

PKGS = {"ref": (ref_csr, ref_gen, ref_sv), "pt": (pt_csr, pt_gen, pt_sv)}


def labeled_graph(pkg, n=120, m=1200, seed=4):
    """test_delta.py's graph: temporal_social with the final graph's
    degree as a second vertex column and an int edge label column."""
    csr, gen, _ = PKGS[pkg]
    g = gen.temporal_social(n, m, seed=seed)
    spec = csr.MetaSpec(v_int=g.spec.v_int + ("degree",), v_float=(),
                        e_int=("elabel",), e_float=g.spec.e_float)
    deg = g.degrees().astype(np.int32)
    vmeta_i = np.concatenate([g.vmeta_i, deg[:, None]], 1)
    elab = (np.arange(g.m, dtype=np.int32) % 7)[:, None]
    return csr.HostGraph(g.n, g.src, g.dst, spec, vmeta_i, None, elab,
                         g.emeta_f)


def ts_batches(g, K):
    order = np.argsort(g.emeta_f[:, 0], kind="stable")
    return np.array_split(order, K)


def empty_base(pkg, g):
    return PKGS[pkg][0].HostGraph(g.n, np.zeros(0, np.int64),
                                  np.zeros(0, np.int64), g.spec, g.vmeta_i,
                                  g.vmeta_f)


def append(dg_or_base, g, idx):
    return dg_or_base.append_edges(g.src[idx], g.dst[idx],
                                   emeta_i=g.emeta_i[idx],
                                   emeta_f=g.emeta_f[idx])


def stream(pkg, g, K):
    """The K epochs' DeltaGraphs from an empty base."""
    dg, out = None, []
    for idx in ts_batches(g, K):
        dg = append(dg if dg is not None else empty_base(pkg, g), g, idx)
        out.append(dg)
    return out


def bundle(pkg, n):
    """test_delta.py's bundle: every bitwise-accumulating built-in."""
    sv = PKGS[pkg][2]
    return sv.SurveyBundle([
        sv.TriangleCount(),
        sv.ClosureTime(ts_col=0),
        sv.LabelTripleSet(v_label_col=0, capacity=1 << 12),
        sv.MaxEdgeLabelDist(n_labels=8, e_label_col=0, v_label_col=0),
        sv.DegreeTriples(deg_col=1, capacity=1 << 12),
        sv.LocalVertexCount(n),
        sv.TopKWeightedTriangles(k=16, weight_col=0),
    ])


def assert_delta_equal(ref, port):
    assert ref.epoch == port.epoch and ref.n == port.n
    assert ref.spec.__dict__ == port.spec.__dict__
    for f in ("d_src", "d_dst", "d_emeta_i", "d_emeta_f"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert_graph_equal(ref.base, port.base)


def assert_graph_equal(a, b):
    assert a.n == b.n and a.spec.__dict__ == b.spec.__dict__
    for f in ("src", "dst", "vmeta_i", "vmeta_f", "emeta_i", "emeta_f"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.sample_p, a.sample_seed) == (b.sample_p, b.sample_seed)


class Epochs:
    """The graph in both packages and the reference's K = 4 epoch runs of
    the bundle, built once per module."""

    def __init__(self):
        self.g = {k: labeled_graph(k) for k in PKGS}
        self.dgs = {k: stream(k, self.g[k], 4) for k in PKGS}
        self.runs = {}

    def plan(self, pkg, dg, survey, mode):
        pp = ref_pp if pkg == "ref" else pt_pp
        return pp.plan_delta(dg, 2, survey, mode=mode, push_cap=64,
                             pull_q_cap=4)

    def ref_run(self, mode):
        """Per epoch: (cfg, report, state as numpy, stats); and the
        finalized result."""
        if mode not in self.runs:
            survey = bundle("ref", self.g["ref"].n)
            state, log = None, []
            for dg in self.dgs["ref"]:
                gr, _ = ref_dodgr.shard_delta(dg, 2)
                cfg, rep = self.plan("ref", dg, survey, mode)
                state, st = ref_engine.survey_delta(gr, survey, cfg, state)
                log.append((cfg, rep, ref_numpy(state), st))
            self.runs[mode] = log, ref_engine.finalize_epochs(survey, state)
        return self.runs[mode]


@pytest.fixture(scope="module")
def epochs():
    return Epochs()


# ---------------------------------------------------------------------------
# host layers


def test_append_edges_dedup_growth_and_frontier_equal_reference():
    """test_delta.py's dedup, growth and epoch cases in both packages, and
    every epoch's union, touched set, frontier and new-class oracle."""
    dgs = {}
    for pkg in PKGS:
        csr = PKGS[pkg][0]
        base = csr.HostGraph.from_edges(4, [0, 1], [1, 2])
        dg = base.append_edges([2, 1, 0, 3, 5], [3, 0, 0, 2, 5])
        dg2 = dg.append_edges([0], [3])
        dg3 = dg2.append_edges([0, 3], [1, 0])
        g = csr.HostGraph.from_edges(
            3, [0, 1], [1, 2], spec=csr.MetaSpec(v_int=("label",)),
            vmeta_i=np.array([[7], [8], [9]], np.int32))
        grown = g.append_edges([2], [4])
        dgs[pkg] = (dg, dg2, dg3, grown)
    for a, b in zip(dgs["ref"], dgs["pt"]):
        assert_delta_equal(a, b)
        assert_graph_equal(a.union(), b.union())
    dg, dg2, dg3, grown = dgs["pt"]
    assert (dg.epoch, dg.n, dg.m_delta) == (1, 6, 1)
    assert set(zip(dg.d_src.tolist(), dg.d_dst.tolist())) == {(2, 3)}
    assert (dg2.epoch, dg2.base.m, dg2.m_delta) == (2, dg.union().m, 1)
    assert (dg3.epoch, dg3.m_delta, dg3.union().m) == (3, 0, dg.union().m + 1)
    assert grown.n == 5 and grown.base.vmeta_i[:, 0].tolist() == [7, 8, 9, 0, 0]

    g = labeled_graph("pt", 80, 500, seed=9)
    for ref_dg, pt_dg in zip(stream("ref", labeled_graph("ref", 80, 500, 9), 3),
                             stream("pt", g, 3)):
        assert_delta_equal(ref_dg, pt_dg)
        np.testing.assert_array_equal(ref_dg.touched(), pt_dg.touched())
        (rh, rnew), (ph, pnew) = ref_dg.frontier(), pt_dg.frontier()
        assert_graph_equal(rh, ph)
        np.testing.assert_array_equal(rnew, pnew)
        assert pt_dg.frontier() is pt_dg.frontier()          # cached
        cls = pt_oracle.new_triangle_classes_ref(ph, pnew)
        assert cls == ref_oracle.new_triangle_classes_ref(rh, rnew)
        u, b = pt_dg.union(), pt_dg.base
        assert cls["noo"] + cls["nno"] + cls["nnn"] == (
            pt_oracle.count_triangles_ref(u, orient="stable")
            - pt_oracle.count_triangles_ref(b, orient="stable"))


def test_io_files_load_in_either_package(tmp_path):
    """Graphs, delta graphs and epoch states written by one package load
    in the other to equal arrays (a sampled base keeps its stamp)."""
    gs = {k: labeled_graph(k, 60, 300, seed=2) for k in PKGS}
    dgs = {k: stream(k, gs[k], 2)[-1] for k in PKGS}
    sampled = {k: (ref_dodgr if k == "ref" else pt_dodgr).sparsify_edges(
        gs[k], 0.5, seed=3).append_edges([0, 1], [2, 3]) for k in PKGS}
    io = {"ref": ref_io, "pt": pt_io}
    for src, dst in (("ref", "pt"), ("pt", "ref")):
        path = str(tmp_path / f"{src}_graph.npz")
        io[src].save_graph(path, gs[src])
        assert_graph_equal(gs[src], io[dst].load_graph(path))
        path = str(tmp_path / f"{src}_delta.npz")
        io[src].save_delta(path, dgs[src])
        assert_delta_equal(dgs[src], io[dst].load_delta(path))
        path = str(tmp_path / f"{src}_state.npz")
        io[src].save_epoch_state(path, sampled[src], token="abc123")
        back, token = io[dst].load_epoch_state(path)
        assert token == "abc123" and back.base.sample_p == 0.5
        assert_delta_equal(sampled[src], back)


def test_plan_delta_shards_and_tokens_equal_reference(epochs):
    """Every epoch's plan_delta config and report (push-pull, and push with
    an automatic hub threshold), shard_delta's shards, and the token
    chain equal the reference's."""
    n = epochs.g["pt"].n
    for dr, dp in zip(epochs.dgs["ref"], epochs.dgs["pt"]):
        for kw in (dict(mode="pushpull", push_cap=64, pull_q_cap=4),
                   dict(mode="push", push_cap=64, hub_theta="auto",
                        transport="ragged")):
            rc, rr = ref_pp.plan_delta(dr, 2, bundle("ref", n), **kw)
            pc, pr = pt_pp.plan_delta(dp, 2, bundle("pt", n), **kw)
            assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
            assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
            assert pc.delta and pc.epoch == dp.epoch and pc.orient == "stable"
            assert_shards_equal(
                ref_dodgr.shard_delta(dr, 2, hub_theta=rc.hub_theta)[0],
                pt_dodgr.shard_delta(dp, 2, hub_theta=pc.hub_theta,
                                     device="cpu")[0])
        assert pt_pp.delta_token(dp) == ref_pp.delta_token(dr)
        assert pt_pp.delta_token(dp, "t0") == ref_pp.delta_token(dr, "t0")
        assert pt_pp.graph_token(dp.union()) == ref_pp.graph_token(dr.union())
    args = ([1, 2], [3, 4], np.ones((2, 1), np.int32), None)
    assert pt_pp.advance_token("x", *args, epoch=7) == \
        ref_pp.advance_token("x", *args, epoch=7)


# ---------------------------------------------------------------------------
# K = 4 epochs of the bundle


@pytest.mark.parametrize("mode", ["push", "pushpull"])
def test_k4_epochs_bundle_equal_reference_and_one_shot(epochs, mode):
    log, ref_result = epochs.ref_run(mode)
    g = epochs.g["pt"]
    survey = bundle("pt", g.n)
    state, stats = None, []
    for dg, (rc, _, ref_state, ref_st) in zip(epochs.dgs["pt"], log):
        gr, _ = pt_dodgr.shard_delta(dg, 2, device="cpu")
        cfg, _ = epochs.plan("pt", dg, survey, mode)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rc)
        state, st = pt_engine.survey_delta(gr, survey, cfg, state)
        assert_tree_equal(ref_state, state_to_numpy(state))
        assert st == ref_st
        stats.append(st)
    result = pt_engine.finalize_epochs(survey, state)
    assert_tree_equal(ref_result, result)
    assert [st["epoch"] for st in stats] == [1.0, 2.0, 3.0, 4.0]
    # the port's own one-shot survey of the union under the stable key
    u = epochs.dgs["pt"][-1].union()
    gr, _ = pt_dodgr.shard_dodgr(u, 2, orient="stable", device="cpu")
    cfg, _ = pt_pp.plan_engine(u, 2, bundle("pt", g.n), mode=mode,
                               orient="stable", push_cap=64, pull_q_cap=4)
    run = (pt_engine.survey_push_only if mode == "push"
           else pt_engine.survey_push_pull)
    full, st_full = run(gr, bundle("pt", g.n), cfg)
    assert_tree_equal(full, result)
    tris = sum(st["tris_push"] + st["tris_pull"] for st in stats)
    assert tris == st_full["tris_push"] + st_full["tris_pull"]
    assert result["TriangleCount"] == pt_oracle.count_triangles_ref(g)


def test_k4_epochs_enumerate_equals_oracle_set():
    """Enumerate accumulates by buffer concatenation: the union of the
    epochs' rows is the union's triangle set."""
    g = labeled_graph("pt", 100, 700, seed=5)
    survey, state = pt_sv.Enumerate(capacity=4096), None
    for dg in stream("pt", g, 4):
        gr, _ = pt_dodgr.shard_delta(dg, 2, device="cpu")
        cfg, _ = pt_pp.plan_delta(dg, 2, survey, mode="pushpull",
                                  push_cap=64, pull_q_cap=4)
        state, _ = pt_engine.survey_delta(gr, survey, cfg, state)
    res = pt_engine.finalize_epochs(survey, state)
    oracle = set()
    pt_oracle.survey_triangles_ref(
        g, lambda p, q, r, m: oracle.add((p, q, r)), orient="stable")
    assert res["total_found"] == len(oracle) and res["overflowed"] == 0
    assert {tuple(t) for t in res["triangles"].tolist()} == oracle


def test_single_epoch_equals_static_survey():
    """Epoch 1 on an empty base: every edge is new, so the delta engine
    gives the static count (and the reference's stats)."""
    out = {}
    for pkg in PKGS:
        g = labeled_graph(pkg, 100, 700, seed=7)
        dg = append(empty_base(pkg, g), g, np.arange(g.m))
        dodgr, pp, eng = ((ref_dodgr, ref_pp, ref_engine) if pkg == "ref"
                          else (pt_dodgr, pt_pp, pt_engine))
        kw = {} if pkg == "ref" else dict(device="cpu")
        gr, _ = dodgr.shard_delta(dg, S=3, **kw)
        survey = PKGS[pkg][2].TriangleCount()
        cfg, _ = pp.plan_delta(dg, 3, survey, mode="pushpull", push_cap=64,
                               pull_q_cap=4)
        state, st = eng.survey_delta(gr, survey, cfg)
        out[pkg] = (eng.finalize_epochs(survey, state), st)
    assert out["pt"] == out["ref"]
    assert out["pt"][0] == pt_oracle.count_triangles_ref(labeled_graph("pt", 100, 700, 7))


# ---------------------------------------------------------------------------
# guards and the order_sensitive warning


def test_delta_provenance_guards():
    g = labeled_graph("pt", 80, 500, seed=9)
    dg, dg2 = stream("pt", g, 2)
    tc = pt_sv.TriangleCount()
    gr_d, _ = pt_dodgr.shard_delta(dg, 2, device="cpu")
    cfg_d, _ = pt_pp.plan_delta(dg, 2, tc, mode="push", push_cap=64)
    gr_f, _ = pt_dodgr.shard_dodgr(dg.union(), 2, device="cpu")
    cfg_f, _ = pt_pp.plan_engine(dg.union(), 2, tc, mode="push")
    with pytest.raises(ValueError, match="delta"):
        pt_engine.survey_push_only(gr_d, tc, cfg_f)
    with pytest.raises(ValueError, match="delta plan"):
        pt_engine.survey_delta(gr_f, tc, cfg_f)
    with pytest.raises(ValueError, match="orientation mismatch"):
        pt_engine.survey_push_only(gr_f, tc, pt_pp.plan_engine(
            dg.union(), 2, tc, mode="push", orient="stable")[0])
    gr_d2, _ = pt_dodgr.shard_delta(dg2, 2, device="cpu")
    with pytest.raises(ValueError, match="epoch mismatch"):
        pt_engine.survey_delta(gr_d2, tc, cfg_d)
    with pytest.raises(ValueError, match="sampling"):
        pt_engine.survey_delta(gr_d, tc, dataclasses.replace(cfg_d, sample_p=0.5))
    # a sampled history keeps its stamp, and its delta epoch is refused
    sampled = pt_dodgr.sparsify_edges(g, 0.5, seed=3).append_edges([0, 1], [2, 3])
    assert sampled.union().sample_p == sampled.frontier()[0].sample_p == 0.5
    gr_s, _ = pt_dodgr.shard_delta(sampled, 2, device="cpu")
    cfg_s, _ = pt_pp.plan_delta(sampled, 2, tc, mode="push")
    with pytest.raises(ValueError, match="sampling"):
        pt_engine.survey_delta(gr_s, tc, cfg_s)


def _warned(eng, gr, survey, cfg, prev):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = eng.survey_delta(gr, survey, cfg, prev)
    return state, [str(w.message) for w in caught
                   if "order_sensitive" in str(w.message)]


def test_order_sensitive_warning_follows_reference():
    """A float32 scatter-add survey is stamped order_sensitive by both
    packages; survey_delta warns exactly when the reference warns (from
    the second epoch on, where merge_epochs runs), and a bitwise survey
    never warns."""
    got = {}
    for pkg in PKGS:
        g = labeled_graph(pkg, 80, 500, seed=9)
        dodgr, pp, eng = ((ref_dodgr, ref_pp, ref_engine) if pkg == "ref"
                          else (pt_dodgr, pt_pp, pt_engine))
        kw = {} if pkg == "ref" else dict(device="cpu")
        for name, survey in (("float", RefFloatAdd() if pkg == "ref" else PtFloatAdd()),
                             ("count", PKGS[pkg][2].TriangleCount())):
            state, seen = None, []
            for dg in stream(pkg, g, 2):
                gr, _ = dodgr.shard_delta(dg, 2, **kw)
                cfg, _ = pp.plan_delta(dg, 2, survey, mode="push", push_cap=64)
                state, w = _warned(eng, gr, survey, cfg, state)
                seen.append((cfg.determinism, len(w)))
            got[pkg, name] = seen, (ref_numpy(state) if pkg == "ref"
                                    else state_to_numpy(state))
    for name in ("float", "count"):
        assert got["pt", name][0] == got["ref", name][0]
        assert_tree_equal(got["ref", name][1], got["pt", name][1])
    assert got["pt", "float"][0] == [("order_sensitive", 0), ("order_sensitive", 1)]
    assert got["pt", "count"][0] == [("bitwise", 0), ("bitwise", 0)]
