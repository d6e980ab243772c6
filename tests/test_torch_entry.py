"""The port's entry points vs the JAX package's: the reference run with
its Pallas kernels in interpret mode, the reference's own shards and plan
carried in through interop, DOULION sampling, the overflow guard, the
mesh plan's schedule and guards, and the path not ported yet (a service
over the mesh). Exact equality throughout."""
import dataclasses

import numpy as np
import torch
import pytest

from repro.core import dodgr as ref_dodgr
from repro.core import engine as ref_engine
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.core.ref import count_triangles_ref as ref_count
from repro.graphs import generators as ref_gen
from repro_torch import interop
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.core.ref import count_triangles_ref
from repro_torch.graphs import generators as pt_gen
from repro_torch.launch.mesh import ShardMesh
from repro_torch.serve import SurveyService
from test_torch_engine import Runs, assert_run_equal, plan, ref_run, surveys

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("g,S,mode,sname", [
    ("karate", 2, "pushpull", "TriangleCount"),
    ("karate", 2, "pushpull", "DegreeTriples"),
    ("rmat7", 4, "push", "TriangleCount"),
])
def test_equal_reference_with_pallas_interpret(runs, g, S, mode, sname):
    """The reference with use_pallas=True (interpret) and the counting
    set's Pallas backend gives the same bits the port does."""
    pair = surveys(sname, backend="pallas")
    rc, pc = plan(runs, g, S, pair, mode, "dense", use_pallas=True)
    gr_ref, gr_pt = runs.shard(g, S)
    ref = ref_run(runs, (g, S, "dense", mode, sname, True), gr_ref, pair[0], rc)
    merged, stats = pt_engine.make_survey_fn(pair[1], pc)(gr_pt)
    assert_run_equal(ref, pair[1], merged, stats)


@pytest.mark.parametrize("sname", ["TriangleCount", "DegreeTriples"])
def test_entry_points_on_reference_shards_and_plan(runs, sname):
    """The reference's exact shards and plan, carried in through interop,
    give the reference's results and stats through the entry points."""
    g, S = "rmat7", 4
    pair = surveys(sname)
    g_ref, _ = runs.graph(g)
    gr_ref, _ = runs.shard(g, S)
    arrays = {f: np.asarray(getattr(gr_ref, f))
              for f in pt_dodgr.PER_SHARD_FIELDS + pt_dodgr.REPLICATED_FIELDS}
    meta = {f: getattr(gr_ref, f) for f in pt_dodgr.META_FIELDS}
    gr = interop.shards_from_arrays(arrays, meta, "cpu")
    for mode, ref_fn, pt_fn in (
            ("push", ref_engine.survey_push_only, pt_engine.survey_push_only),
            ("pushpull", ref_engine.survey_push_pull, pt_engine.survey_push_pull)):
        rc, _ = ref_pp.plan_engine(g_ref, S, pair[0], mode=mode, push_cap=64,
                                   pull_q_cap=4, transport="ragged")
        cfg = interop.engine_config_from_fields(dataclasses.asdict(rc))
        assert cfg == pt_engine.EngineConfig(**dataclasses.asdict(rc))
        r_res, r_stats = ref_fn(gr_ref, pair[0], rc)
        p_res, p_stats = pt_fn(gr, pair[1], cfg)
        assert p_res == r_res
        assert p_stats == r_stats
        assert p_stats["exact"]
    assert ref_count(g_ref) == count_triangles_ref(runs.graph(g)[1])


def test_sampled_run_equals_reference():
    g_ref = ref_gen.temporal_social(120, 1200, seed=4)
    g_pt = pt_gen.temporal_social(120, 1200, seed=4)
    kw = dict(sample_p=0.5, sample_seed=3)
    gr_ref, _ = ref_dodgr.shard_dodgr(g_ref, 2, **kw)
    gr_pt, _ = pt_dodgr.shard_dodgr(g_pt, 2, device="cpu", **kw)
    rc, _ = ref_pp.plan_engine(g_ref, 2, ref_sv.TriangleCount(), mode="push",
                               push_cap=64, **kw)
    pc, _ = pt_pp.plan_engine(g_pt, 2, pt_sv.TriangleCount(), mode="push",
                              push_cap=64, **kw)
    assert ref_engine.survey_push_only(gr_ref, ref_sv.TriangleCount(), rc) == \
        pt_engine.survey_push_only(gr_pt, pt_sv.TriangleCount(), pc)


def test_overflow_flags_inexact_like_reference():
    g = pt_gen.rmat(7, 8, seed=1)
    gr, _ = pt_dodgr.shard_dodgr(g, 2, device="cpu")
    cfg, _ = pt_pp.plan_engine(g, 2, pt_sv.TriangleCount(), mode="pushpull",
                               push_cap=64, pull_q_cap=4)
    short = dataclasses.replace(cfg, n_push_steps=1, pull_edge_cap=2)
    with pytest.warns(RuntimeWarning, match="INEXACT"):
        _, st = pt_engine.survey_push_pull(gr, pt_sv.TriangleCount(), short)
    assert not st["exact"]
    with pytest.raises(RuntimeError, match="INEXACT"):
        pt_engine.survey_push_pull(gr, pt_sv.TriangleCount(),
                                   dataclasses.replace(short, on_overflow="raise"))


def test_unported_paths_raise_and_name_the_roadmap():
    """The hub lane, delta epochs and the mesh transport, which raised here
    until they were ported, now run or plan: a mesh plan stamps the
    reference's round schedule and, off a mesh, raises the reference's
    guard; a mesh whose size is not S raises. The service over a mesh is
    not ported and still names the roadmap."""
    g = pt_gen.rmat(7, 8, seed=1).with_degree_meta()
    tc = pt_sv.TriangleCount()
    gr_hub, _ = pt_dodgr.shard_dodgr(g, 2, hub_theta=10, device="cpu")
    cfg_hub, _ = pt_pp.plan_engine(g, 2, tc, hub_theta=10)
    res, st = pt_engine.survey_push_pull(gr_hub, tc, cfg_hub)
    assert res == ref_count(ref_gen.rmat(7, 8, seed=1)) and st["tris_hub"] > 0
    gr, _ = pt_dodgr.shard_dodgr(g, 2, device="cpu")
    cfg, _ = pt_pp.plan_engine(g, 2, tc)
    g_ref = ref_gen.rmat(7, 8, seed=1).with_degree_meta()
    cfg_m, rep_m = pt_pp.plan_engine(g, 2, tc, transport="mesh", push_cap=64,
                                     pull_q_cap=4)
    rc_m, rr_m = ref_pp.plan_engine(g_ref, 2, ref_sv.TriangleCount(),
                                    transport="mesh", push_cap=64, pull_q_cap=4)
    assert dataclasses.asdict(rep_m) == dataclasses.asdict(rr_m)
    assert dataclasses.asdict(cfg_m) == dataclasses.asdict(rc_m)
    assert rep_m.sched_push_rounds > 0 and rep_m.sched_req_rounds > 0
    with pytest.raises(ValueError, match="transport='mesh'") as pt_err:
        pt_engine.survey_push_pull(gr, tc, cfg_m)
    gr_ref, _ = ref_dodgr.shard_dodgr(g_ref, 2)
    with pytest.raises(ValueError) as ref_err:
        ref_engine.survey_push_pull(gr_ref, ref_sv.TriangleCount(), rc_m)
    assert str(pt_err.value) == str(ref_err.value)
    four = ShardMesh(rank=0, size=4, backend="gloo", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="S=2 shards"):
        pt_engine.survey_push_pull(gr, tc, cfg_m, mesh=four)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SurveyService(g, 2, mesh=four, device="cpu")
    dg = g.append_edges([0], [1])
    cfg_d, _ = pt_pp.plan_delta(dg, 2, tc)
    gr_d, _ = pt_dodgr.shard_delta(dg, 2, device="cpu")
    state, _ = pt_engine.survey_delta(gr_d, tc, cfg_d)
    assert pt_engine.finalize_epochs(tc, state) == (
        ref_count(ref_gen.rmat(7, 8, seed=1).append_edges([0], [1]).union(),
                  orient="stable")
        - ref_count(ref_gen.rmat(7, 8, seed=1), orient="stable"))
    with pytest.raises(ValueError, match="sampling mismatch"):
        pt_engine.survey_push_only(gr, tc, dataclasses.replace(cfg, sample_p=0.5))
