"""The port's mesh transport (one shard per torch.distributed rank) vs the
JAX package's stacked runs, on the CPU.

One spawn of S = 4 gloo rank processes per module (torch at one thread,
``device="cpu"``) runs every mesh case while the parent computes the
reference runs: the bundle of all eight built-ins, push and push-pull,
over scheduled rounds (ragged caps) against the reference's stacked
ragged run, and each built-in alone against the port's stacked run;
uniform caps (a dense plan relabelled ``mesh``) against the reference's
dense run; a hub θ cell against the port's stacked ragged + hub run; K = 3
delta epochs against the reference's ``finalize_epochs``;
``MeshExchange`` scatter then gather on five cap kinds against the
stacked ``RaggedExchange``; the bytes handed to the collectives per lane
against the plan; and tests/test_mesh.py's guard on the mesh size. Exact
equality throughout (float32 included). The schedules and the planner:
tests/test_torch_round_schedule.py, tests/test_torch_mesh_plan.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.exchange import RaggedExchange as RefRaggedExchange
from repro.core import dodgr as ref_dodgr
from repro.core import engine as ref_engine
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro_torch.comm.exchange import RaggedExchange
from repro_torch.comm.mesh_exchange import MeshExchange
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.interop import state_to_numpy
from repro_torch.launch.mesh import RankRun
from test_exchange import _hub_theta_for
from test_round_schedule import _rand_caps
from test_torch_delta import bundle as bundle7, labeled_graph, stream
from test_torch_surveys_meta import assert_tree_equal, bundle as bundle8, ref_numpy

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

S = 4
KW = dict(push_cap=64, pull_q_cap=4)
MODES = ("push", "pushpull")
PKG = {"ref": (ref_sv, ref_dodgr, ref_pp), "pt": (pt_sv, pt_dodgr, pt_pp)}
NAMES = bundle8(pt_sv, 1).names
EXCHANGE_KINDS = ("plain", "hub-col", "hub-pairs", "hub-pairs+zero-row",
                  "uniform")


# ---------------------------------------------------------------------------
# the mesh runs: one spawn of S ranks, the references meanwhile


def _exchange_caps(kind):
    if kind == "uniform":
        return np.full((S, S), 5, np.int64)
    return _rand_caps(11, s=S, skew_col=kind == "hub-col",
                      skew_pairs="pairs" in kind, zero_row="zero" in kind)


def _exchange_tree(caps):
    out_cap = RaggedExchange(caps).out_cap
    rng = np.random.default_rng(3)
    return dict(
        x=torch.as_tensor(rng.integers(-2**30, 2**30, (S, out_cap), np.int32)),
        b=torch.as_tensor(rng.integers(0, 2, (S, out_cap)).astype(bool)),
        f=torch.as_tensor(rng.standard_normal((S, out_cap, 2)).astype(np.float32)))


class MeshRuns:
    """Every mesh case as one job list on S rank processes; the parent's
    plans, shards and reference runs."""

    def __init__(self, workdir):
        self.g = {pkg: labeled_graph(pkg, 96, 700, seed=4) for pkg in PKG}
        self.n = self.g["pt"].n
        self.theta = _hub_theta_for(self.g["ref"])
        self.jobs, self.index, self.plans = [], {}, {}
        self.gr = {}
        for theta in (0, self.theta):
            self.gr[theta] = {
                "ref": ref_dodgr.shard_dodgr(self.g["ref"], S,
                                             hub_theta=theta)[0],
                "pt": pt_dodgr.shard_dodgr(self.g["pt"], S, hub_theta=theta,
                                           device="cpu")[0]}
        for mode in MODES:
            for cell in ("ragged", "uniform", "hub"):
                self._survey_job(("bundle", cell, mode), "bundle", cell, mode)
            for name in NAMES:
                self._survey_job(("alone", name, mode), name, "ragged", mode)
        self._delta_job()
        for kind in EXCHANGE_KINDS:
            caps = _exchange_caps(kind)
            self._add(("exchange", kind),
                      dict(kind="exchange", caps=caps, tree=_exchange_tree(caps)))
        g2 = self.g["pt"]
        cfg2, _ = pt_pp.plan_engine(g2, 2, pt_sv.TriangleCount(), mode="push",
                                    transport="mesh", push_cap=64)
        self._add(("guard",), dict(
            kind="error", gr=pt_dodgr.shard_dodgr(g2, 2, device="cpu")[0],
            survey=pt_sv.TriangleCount(), cfg=cfg2, entry="push"))
        self.run = RankRun(S, self.jobs, workdir, device="cpu",
                           timeout=300).start()
        try:
            # the reference runs the cells the JAX package's test_mesh.py
            # holds the mesh to; the port's stacked runs the rest
            self.ref = {key: self._reference(key) for key in self.index
                        if key[0] == "delta"
                        or key[0] == "bundle" and key[1] != "hub"}
            self.stacked = {key: self._stacked(key) for key in self.index
                            if key[0] == "alone" or key[1:2] == ("hub",)}
        finally:
            self.ranks = self.run.wait()

    def _add(self, key, job):
        self.index[key] = len(self.jobs)
        self.jobs.append(job)

    def _survey(self, pkg, name):
        b = bundle8(PKG[pkg][0], self.n)
        return b if name == "bundle" else b.surveys[b.names.index(name)]

    def plan(self, pkg, name, cell, mode, transport):
        theta = self.theta if cell == "hub" else 0
        return PKG[pkg][2].plan_engine(
            self.g[pkg], S, self._survey(pkg, name), mode=mode,
            transport=transport, hub_theta=theta, **KW)

    def _survey_job(self, key, name, cell, mode):
        # the reference's (and the port's stacked) transport, and the plan
        # the mesh runs: ragged caps for "ragged" and "hub", a dense plan
        # relabelled mesh for "uniform"
        stacked = "dense" if cell == "uniform" else "ragged"
        cfg, rep = self.plan("pt", name, cell, mode, stacked)
        if cell == "uniform":
            mcfg = dataclasses.replace(cfg, transport="mesh")
        else:
            mcfg, rep = self.plan("pt", name, cell, mode, "mesh")
            assert dataclasses.replace(mcfg, transport=stacked) == cfg
        self.plans[key] = (cfg, mcfg, rep, stacked)
        theta = cfg.hub_theta
        self._add(key, dict(kind="survey", gr=self.gr[theta]["pt"],
                            survey=self._survey("pt", name), cfg=mcfg,
                            entry="fn"))

    def _delta_job(self):
        grs, cfgs = [], []
        for dg in stream("pt", self.g["pt"], 3):
            cfg, _ = pt_pp.plan_delta(dg, S, bundle7("pt", self.n),
                                      mode="pushpull", transport="mesh", **KW)
            grs.append(pt_dodgr.shard_delta(dg, S, hub_theta=cfg.hub_theta,
                                            device="cpu")[0])
            cfgs.append(cfg)
        self._add(("delta",), dict(kind="delta", grs=grs, cfgs=cfgs,
                                   survey=bundle7("pt", self.n)))

    def _reference(self, key):
        if key[0] == "delta":
            survey = bundle7("ref", self.n)
            state, stats = None, []
            for dg in stream("ref", self.g["ref"], 3):
                cfg, _ = ref_pp.plan_delta(dg, S, survey, mode="pushpull",
                                           transport="ragged", **KW)
                gr, _ = ref_dodgr.shard_delta(dg, S, hub_theta=cfg.hub_theta)
                state, st = ref_engine.survey_delta(gr, survey, cfg, state)
                stats.append(st)
            return (ref_numpy(state), stats,
                    ref_engine.finalize_epochs(survey, state))
        _, name, mode = key
        cell = key[1]
        rc, _ = self.plan("ref", "bundle", cell, mode, self.plans[key][3])
        survey = self._survey("ref", "bundle")
        merged, stats = jax.jit(ref_engine.make_survey_fn(survey, rc))(
            self.gr[rc.hub_theta]["ref"])
        return (ref_numpy(merged), {k: float(v) for k, v in stats.items()},
                survey.finalize(merged))

    def _stacked(self, key):
        cfg = self.plans[key][0]
        survey = self._survey("pt", "bundle" if key[0] == "bundle" else key[1])
        merged, stats = pt_engine.make_survey_fn(survey, cfg)(
            self.gr[cfg.hub_theta]["pt"])
        return state_to_numpy(merged), stats, survey.finalize(merged)

    def out(self, key, rank=0):
        return self.ranks[rank]["outputs"][self.index[key]]

    def each_rank(self, key):
        return [r["outputs"][self.index[key]] for r in self.ranks]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MeshRuns(tmp_path_factory.mktemp("mesh"))


def _assert_run(want, outs):
    """Every rank's merged state, stats and result equal ``want``."""
    w_state, w_stats, w_result = want
    for o in outs:
        assert_tree_equal(w_state, o["state"])
        assert o["stats"] == w_stats
        assert_tree_equal(w_result, o["result"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cell", ["ragged", "uniform", "hub"])
def test_mesh_bundle_equals_reference(runs, cell, mode):
    """The bundle of all eight: scheduled rounds == the reference's stacked
    ragged run, uniform caps (all_to_all_single) == its dense run, the hub
    θ cell == the port's stacked ragged + hub run: states, stats,
    results."""
    key = ("bundle", cell, mode)
    want = runs.stacked[key] if cell == "hub" else runs.ref[key]
    _assert_run(want, runs.each_rank(key))
    st = runs.out(key)["stats"]
    assert st["pull_overflow"] == st["stream_dropped"] == 0.0
    if cell == "hub":
        assert st["wedges_hub"] > 0 and st["tris_hub"] > 0
    assert runs.out(key)["result"]["TriangleCount"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_mesh_survey_alone_equals_stacked(runs, mode):
    """Each of the eight built-ins alone, scheduled rounds: every rank ==
    the port's stacked ragged run."""
    for name in NAMES:
        key = ("alone", name, mode)
        _assert_run(runs.stacked[key], runs.each_rank(key))


def test_mesh_delta_epochs_equal_reference(runs):
    """K = 3 timestamp-ordered batches through survey_delta on the mesh:
    the accumulated state, every epoch's stats and finalize_epochs equal
    the reference's stacked ragged stream."""
    w_state, w_stats, w_result = runs.ref[("delta",)]
    for o in runs.each_rank(("delta",)):
        assert_tree_equal(w_state, o["state"])
        assert o["stats"] == [{k: (bool(v) if k == "exact" else float(v))
                               for k, v in st.items()} for st in w_stats]
        assert all(st["exact"] for st in o["stats"])
        assert_tree_equal(w_result, o["result"])


@pytest.mark.parametrize("kind", EXCHANGE_KINDS)
def test_mesh_exchange_equals_stacked_on_live_slots(runs, kind):
    """MeshExchange scatter, then gather of what it delivered: equal to the
    stacked RaggedExchange (the port's and the reference's) on live recv
    slots and real send slots."""
    caps = _exchange_caps(kind)
    job = runs.jobs[runs.index[("exchange", kind)]]
    stk, ref = RaggedExchange(caps), RefRaggedExchange(caps)
    want = stk.scatter(job["tree"])
    back = stk.gather(want)
    ref_want = ref.scatter({k: jnp.asarray(v.numpy())
                            for k, v in job["tree"].items()})
    recv_ok = stk.recv_ok
    send_ok = stk.dest_of < S
    outs = runs.each_rank(("exchange", kind))
    for k in job["tree"]:
        got = torch.cat([o["scatter"][k] for o in outs]).numpy()
        np.testing.assert_array_equal(got[recv_ok], want[k].numpy()[recv_ok])
        np.testing.assert_array_equal(got[recv_ok],
                                      np.asarray(ref_want[k])[recv_ok])
        got = torch.cat([o["gather"][k] for o in outs]).numpy()
        np.testing.assert_array_equal(got[send_ok], back[k].numpy()[send_ok])
        # a round trip returns every real slot's own entry
        np.testing.assert_array_equal(got[send_ok],
                                      job["tree"][k].numpy()[send_ok])
    mx = MeshExchange(caps)
    assert mx.uniform == (kind == "uniform")
    assert mx.wire_round_slots() == outs[0]["wire_round_slots"]
    if "pairs" in kind:   # a schedule away from the rotation
        assert mx.schedule.wire_slots <= mx.naive_schedule.wire_slots
    words = 1 + 1 + 2                        # x, b as int32, f's two lanes
    for lane in ("scatter", "gather"):
        per_rank = [o["bytes"].get(lane, 0) for o in outs]
        assert sum(per_rank) == mx.sent_round_slots() * words * 4
        assert max(per_rank) <= mx.wire_round_slots() * words * 4


def _wire_words(cfg, gr):
    w_push, w_row, w_hdr, w_req = cfg.meta_widths
    Lr = cfg.pull_row_cap if cfg.pull_row_cap else gr.d_plus_max
    return dict(push=w_push, req=w_req, reply=w_hdr + Lr * w_row)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cell", ["ragged", "uniform", "hub"])
def test_collective_bytes_equal_the_plan(runs, cell, mode):
    """Bytes handed to the collectives, summed over ranks, per lane: the
    VolumeReport's wire bytes on uniform caps (the all-to-all block, self
    chunk included); on scheduled rounds each source's padded slice,
    ``MeshExchange.sent_round_slots()``, per superstep, and per rank at
    most the schedule's ``wire_slots`` (the reference's count)."""
    key = ("bundle", cell, mode)
    cfg, mcfg, rep, _ = runs.plans[key]
    outs = runs.each_rank(key)
    words = _wire_words(mcfg, runs.gr[mcfg.hub_theta]["pt"])
    lanes = [("push", mcfg.n_push_steps, mcfg.push_cap, mcfg.push_caps,
              rep.wire_push_bytes, rep.sched_push_slots)]
    if mode == "pushpull":
        lanes += [(lane, mcfg.n_pull_steps, mcfg.pull_q_cap, mcfg.pull_caps,
                   vol, rep.sched_req_slots)
                  for lane, vol in (("req", rep.wire_req_bytes),
                                    ("reply", rep.wire_reply_bytes))]
    for lane, steps, cap, caps, volume, sched_slots in lanes:
        per_rank = [o["bytes"][lane] for o in outs]
        assert all(o["calls"][lane] > 0 for o in outs) or cell != "uniform"
        mx = (MeshExchange(np.asarray(caps)) if caps is not None
              else MeshExchange(np.full((S, S), cap)))
        assert sum(per_rank) == steps * mx.sent_round_slots() * words[lane] * 4
        if cell == "uniform":
            assert sum(per_rank) == volume
        else:
            assert mx.wire_round_slots() == sched_slots
            assert max(per_rank) <= steps * sched_slots * words[lane] * 4
    assert not any("push_back" in o["bytes"] for o in outs)


def test_mesh_size_must_match_shards(runs):
    """tests/test_mesh.py's second guard: a 2-shard graph on 4 ranks."""
    for o in runs.each_rank(("guard",)):
        assert "S=2 shards" in o["error"]


def test_ranks_report_setup_and_wire_time(runs):
    """Each rank reports its set-up seconds and its seconds in the
    collectives; on the CPU nothing is staged and no kernel launches (the
    wrappers take their plain versions)."""
    for r in runs.ranks:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert 0 < r["ready_s"] < 120
        o = r["outputs"][runs.index[("bundle", "ragged", "pushpull")]]
        assert o["wire_s"] > 0 and o["stage_s"] == 0
        assert not any(o["launches"].values())
