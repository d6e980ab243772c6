"""The mesh transport's host side in the port vs the JAX package's:
``plan_engine(transport="mesh")``'s configs and reports, field by field
(the ``sched_*`` / ``naive_*`` schedule fields included), on
tests/test_delta.py's graph and tests/test_round_schedule.py's skewed
DOULION cell; the round schedules of that file's meshes of 2, 3 and 5
ranks and of an all-zero cap matrix; the guard that a mesh plan needs a
mesh; ``shard_slice``. Exact equality throughout."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dodgr as ref_dodgr
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import generators as ref_gen
from repro_torch.comm import round_schedule as pt_rs
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import generators as pt_gen
from test_exchange import _hub_theta_for
from test_round_schedule import _CASES, _birkhoff_T
from test_torch_delta import labeled_graph
from test_torch_round_schedule import _assert_same_schedules
from test_torch_surveys_meta import bundle as bundle8

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

S = 4
KW = dict(push_cap=64, pull_q_cap=4)
MODES = ("push", "pushpull")
PKG = {"ref": (ref_sv, ref_dodgr, ref_pp), "pt": (pt_sv, pt_dodgr, pt_pp)}


@pytest.mark.parametrize("caps", [c for _, c in _CASES if c.shape[0] != 8],
                         ids=[n for n, c in _CASES if c.shape[0] != 8])
def test_small_mesh_schedules_equal_reference(caps):
    """tests/test_round_schedule.py's meshes of 2, 3 and 5 ranks."""
    assert caps.shape[0] in (2, 3, 5)
    _assert_same_schedules(caps)
    assert pt_rs.best_schedule(caps).wire_slots == _birkhoff_T(caps)


def test_zero_caps_schedule_nothing():
    caps = np.zeros((8, 8), np.int64)
    _assert_same_schedules(caps)
    for mk in (pt_rs.rotation_schedule, pt_rs.greedy_schedule,
               pt_rs.bvn_schedule, pt_rs.best_schedule):
        sc = mk(caps)
        assert sc.n_rounds == 0 and sc.wire_slots == 0 and sc.local_parts == ()


def _planner_cases():
    return [("labeled", mode, hub) for mode in MODES for hub in (False, True)] \
        + [("skew-doulion", "pushpull", False)]


@pytest.mark.parametrize("graph,mode,hub", _planner_cases())
def test_mesh_plan_equals_reference(graph, mode, hub):
    """plan_engine(transport='mesh'): EngineConfig and VolumeReport equal
    the reference's field by field, the schedule fields stamped."""
    out = {}
    for pkg, gen in (("ref", ref_gen), ("pt", pt_gen)):
        sv, _, pp = PKG[pkg]
        if graph == "labeled":
            g = labeled_graph(pkg, 96, 700, seed=4)
            kw = dict(KW, hub_theta=_hub_theta_for(g) if hub else 0)
            args = (g, 8, bundle8(sv, g.n))
        else:   # tests/test_round_schedule.py's skewed DOULION cell
            g = gen.rmat(9, 16, seed=5, a=0.75, b=0.055, c=0.055)
            kw = dict(push_cap=512, pull_q_cap=16, sample_p=0.05)
            args = (g, 8, sv.TriangleCount())
        out[pkg] = pp.plan_engine(*args, mode=mode, transport="mesh", **kw)
    (rc, rr), (pc, pr) = out["ref"], out["pt"]
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert pr.sched_push_rounds > 0 and pr.sched_push_slots > 0
    assert pr.sched_push_slots <= pr.naive_push_slots
    assert pr.sched_req_slots <= pr.naive_req_slots
    if mode == "pushpull" and graph != "labeled":
        assert pr.sched_req_rounds > 0


def test_mesh_plan_requires_mesh():
    """tests/test_mesh.py's first guard: a mesh plan on the stacked path."""
    g = labeled_graph("pt", 96, 700, seed=4)
    cfg, _ = pt_pp.plan_engine(g, S, pt_sv.TriangleCount(), mode="push",
                               transport="mesh", push_cap=64)
    gr, _ = pt_dodgr.shard_dodgr(g, S, device="cpu")
    with pytest.raises(ValueError, match="transport='mesh'"):
        pt_engine.survey_push_only(gr, pt_sv.TriangleCount(), cfg)


def test_shard_slice_takes_one_row_and_the_hub_tables():
    g = labeled_graph("pt", 96, 700, seed=4)
    gr, _ = pt_dodgr.shard_dodgr(g, S, hub_theta=_hub_theta_for(g),
                                 device="cpu")
    for r in range(S):
        sl = pt_dodgr.shard_slice(gr, r, device="cpu")
        for f in pt_dodgr.META_FIELDS:
            assert getattr(sl, f) == getattr(gr, f), f
        for f in pt_dodgr.PER_SHARD_FIELDS:
            assert torch.equal(getattr(sl, f), getattr(gr, f)[r:r + 1]), f
            x = getattr(gr, f)
            assert getattr(sl, f).untyped_storage().nbytes() == \
                x[r:r + 1].numel() * x.element_size(), f   # no view of gr
        for f in pt_dodgr.REPLICATED_FIELDS:
            assert torch.equal(getattr(sl, f), getattr(gr, f)), f
    with pytest.raises(ValueError, match="not a shard"):
        pt_dodgr.shard_slice(gr, S)
