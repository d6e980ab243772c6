"""The port's survey engine on the CPU vs the JAX package's: merged
states (limbs; count and packed tables), finalized results and stats,
bit for bit, for push and push-pull × dense and ragged × TriangleCount
and DegreeTriples; the triangle count also against the pure-Python
oracle. The JAX runs share a module-scoped cache."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

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
from repro_torch.core.ref import count_triangles_ref, wedge_count_ref
from repro_torch.graphs import generators as pt_gen

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

GRAPHS = {
    "clique8": lambda gen: gen.clique(8),
    "karate": lambda gen: gen.karate(),
    "rmat7": lambda gen: gen.rmat(7, 8, seed=1),
    "er": lambda gen: gen.erdos_renyi(150, 900, seed=2),
    "rmat9": lambda gen: gen.rmat(9, 16, seed=0),
}
CASES = [("clique8", 1, "dense"), ("karate", 2, "ragged"),
         ("rmat7", 4, "dense"), ("er", 4, "ragged"), ("rmat9", 2, "dense")]


def surveys(name, backend="auto"):
    if name == "TriangleCount":
        return ref_sv.TriangleCount(), pt_sv.TriangleCount()
    return (ref_sv.DegreeTriples(capacity=4096, counting_backend=backend),
            pt_sv.DegreeTriples(capacity=4096))


class Runs:
    """Graphs, shards and reference runs, built once per module."""

    def __init__(self):
        self.graphs, self.shards, self.ref = {}, {}, {}

    def graph(self, g):
        if g not in self.graphs:
            self.graphs[g] = (GRAPHS[g](ref_gen).with_degree_meta(),
                              GRAPHS[g](pt_gen).with_degree_meta())
        return self.graphs[g]

    def shard(self, g, S):
        if (g, S) not in self.shards:
            g_ref, g_pt = self.graph(g)
            self.shards[(g, S)] = (ref_dodgr.shard_dodgr(g_ref, S)[0],
                                   pt_dodgr.shard_dodgr(g_pt, S, device="cpu")[0])
        return self.shards[(g, S)]


@pytest.fixture(scope="module")
def runs():
    return Runs()


def plan(runs, g, S, survey_pair, mode, transport, use_pallas=False):
    g_ref, g_pt = runs.graph(g)
    kw = dict(mode=mode, push_cap=128, pull_q_cap=8, transport=transport)
    rc, _ = ref_pp.plan_engine(g_ref, S, survey_pair[0], use_pallas=use_pallas, **kw)
    pc, _ = pt_pp.plan_engine(g_pt, S, survey_pair[1], use_pallas=use_pallas, **kw)
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    return rc, pc


def ref_run(runs, key, gr, survey, cfg):
    if key not in runs.ref:
        merged, stats = jax.jit(ref_engine.make_survey_fn(survey, cfg))(gr)
        runs.ref[key] = ({k: np.asarray(v) for k, v in merged.items()},
                         {k: float(v) for k, v in stats.items()},
                         survey.finalize(merged))
    return runs.ref[key]


def assert_run_equal(ref, survey, merged, stats):
    r_merged, r_stats, r_result = ref
    port = interop.state_to_numpy(merged)
    assert port.keys() == r_merged.keys()
    for k in port:
        assert port[k].dtype == r_merged[k].dtype, k
        np.testing.assert_array_equal(port[k], r_merged[k], err_msg=k)
    assert stats == r_stats
    assert survey.finalize(merged) == r_result


@pytest.mark.parametrize("sname", ["TriangleCount", "DegreeTriples"])
@pytest.mark.parametrize("mode", ["push", "pushpull"])
@pytest.mark.parametrize("g,S,transport", CASES)
def test_survey_state_stats_result_equal_reference(runs, g, S, transport,
                                                   mode, sname):
    pair = surveys(sname)
    rc, pc = plan(runs, g, S, pair, mode, transport)
    gr_ref, gr_pt = runs.shard(g, S)
    ref = ref_run(runs, (g, S, transport, mode, sname, False), gr_ref, pair[0], rc)
    merged, stats = pt_engine.make_survey_fn(pair[1], pc)(gr_pt)
    assert_run_equal(ref, pair[1], merged, stats)
    t = count_triangles_ref(runs.graph(g)[1])
    if sname == "TriangleCount":
        assert pair[1].finalize(merged) == t
        assert int(stats["wedges_pushed"] + stats["wedges_pulled"]) == \
            wedge_count_ref(runs.graph(g)[1])
    else:
        res = pair[1].finalize(merged)
        assert sum(res["counts"].values()) + res["count_in_collided"] == t
