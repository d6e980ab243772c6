"""The port's hub lane and hub-table cache vs the JAX package's.

A forced hub threshold on rmat(9, 16) and temporal_social(200, 2000), with
a bundle of all eight built-ins, push and push-pull, dense and ragged,
fused and split pull kernels: merged states, stats (``wedges_hub``,
``tris_hub`` included) and results equal the reference's. HubTableCache's
tables equal the reference's at every epoch; a cache-served delta stream
of K = 4 batches of the bundle of seven equals the reference's and the
port's rebuilt stream, in push and push-pull, and a stream from an empty
base equals one survey of the union; the stable-key, epoch-gap and
hub-set refusals. Exact equality throughout. Reference runs are shared
through module fixtures."""
import dataclasses

import jax
import numpy as np
import pytest
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
from repro_torch.core.ref import count_triangles_ref
from repro_torch.graphs import csr as pt_csr
from repro_torch.graphs import generators as pt_gen
from repro_torch.interop import state_to_numpy
from test_torch_delta import append, bundle as bundle7, empty_base, labeled_graph
from test_torch_surveys_meta import (assert_tree_equal, bundle as bundle8,
                                     labeled, ref_numpy)

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

MODS = {"ref": (ref_csr, ref_gen, ref_sv, ref_dodgr, ref_pp, ref_engine),
        "pt": (pt_csr, pt_gen, pt_sv, pt_dodgr, pt_pp, pt_engine)}


def rmat_meta(pkg):
    """rmat(9, 16) with the bundle's columns: vertex label in [0, 16) and
    degree, edge timestamp in [0, 1e6) and its bucket, from a seeded
    numpy draw."""
    csr, gen = MODS[pkg][:2]
    g = gen.rmat(9, 16, seed=0)
    rng = np.random.default_rng(2)
    label = rng.integers(0, 16, g.n).astype(np.int32)
    ts = rng.random(g.m, dtype=np.float32) * np.float32(1e6)
    tsb = (ts / ts.max() * 15).astype(np.int32)
    spec = csr.MetaSpec(v_int=("label",), e_int=("tsbucket",), e_float=("ts",))
    return csr.HostGraph(g.n, g.src, g.dst, spec, label[:, None], None,
                         tsb[:, None], ts[:, None]).with_degree_meta()


GRAPHS = {"rmat9": (rmat_meta, 90), "social": (lambda pkg: labeled(
    MODS[pkg][1], MODS[pkg][0]), 60)}
# (graph, mode, transport): half the product, each graph both modes and
# both transports
CASES = [("rmat9", "pushpull", "dense"), ("rmat9", "push", "ragged"),
         ("social", "pushpull", "ragged"), ("social", "push", "dense")]


class Hubs:
    """Graphs, shards, plans and reference runs of the hub lane, built
    once."""

    def __init__(self):
        self.g, self.gr, self.ref, self.plans = {}, {}, {}, {}

    def graph(self, name):
        if name not in self.g:
            make, theta = GRAPHS[name]
            self.g[name] = {pkg: make(pkg) for pkg in MODS}
            self.gr[name] = {
                "ref": ref_dodgr.shard_dodgr(self.g[name]["ref"], 4,
                                             hub_theta=theta)[0],
                "pt": pt_dodgr.shard_dodgr(self.g[name]["pt"], 4,
                                           hub_theta=theta, device="cpu")[0]}
        return self.g[name], self.gr[name]

    def plan(self, name, mode, transport):
        key = (name, mode, transport)
        if key not in self.plans:
            g, _ = self.graph(name)
            kw = dict(mode=mode, push_cap=128, pull_q_cap=8,
                      transport=transport, hub_theta=GRAPHS[name][1],
                      hub_wedge_cap=128)
            n = g["pt"].n
            rc, _ = ref_pp.plan_engine(g["ref"], 4, bundle8(ref_sv, n), **kw)
            pc, _ = pt_pp.plan_engine(g["pt"], 4, bundle8(pt_sv, n), **kw)
            assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
            self.plans[key] = rc, pc
        return self.plans[key]

    def ref_run(self, name, mode, transport):
        key = (name, mode, transport)
        if key not in self.ref:
            g, gr = self.graph(name)
            rc, _ = self.plan(name, mode, transport)
            survey = bundle8(ref_sv, g["ref"].n)
            merged, stats = jax.jit(ref_engine.make_survey_fn(survey, rc))(
                gr["ref"])
            self.ref[key] = (ref_numpy(merged),
                             {k: float(v) for k, v in stats.items()},
                             survey.finalize(merged))
        return self.ref[key]


@pytest.fixture(scope="module")
def hubs():
    return Hubs()


@pytest.mark.parametrize("name,mode,transport,kernel", [
    c + (k,) for c in CASES
    for k in (("fused", "split") if c[1] == "pushpull" else ("fused",))])
def test_hub_lane_bundle_equals_reference(hubs, name, mode, transport, kernel):
    r_merged, r_stats, r_result = hubs.ref_run(name, mode, transport)
    g, gr = hubs.graph(name)
    _, pc = hubs.plan(name, mode, transport)
    assert pc.n_hub_steps > 1 and gr["pt"].n_hubs > 1
    survey = bundle8(pt_sv, g["pt"].n)
    merged, stats = pt_engine.make_survey_fn(
        survey, dataclasses.replace(pc, pull_kernel=kernel))(gr["pt"])
    assert_tree_equal(r_merged, state_to_numpy(merged))
    assert stats == r_stats
    assert_tree_equal(r_result, survey.finalize(merged))
    t = count_triangles_ref(g["pt"])
    assert survey.finalize(merged)["TriangleCount"] == t
    assert 0 < stats["tris_hub"] < t and stats["wedges_hub"] > 0


# ---------------------------------------------------------------------------
# hub tables across delta epochs


def warm_stream(pkg, g, K, base_frac=0.5):
    """test_hub_reuse.py's stream: the first half of the timestamp order
    as the base, the rest in K batches."""
    csr = MODS[pkg][0]
    order = np.argsort(g.emeta_f[:, 0], kind="stable")
    cut = int(len(order) * base_frac)
    b = order[:cut]
    base = csr.HostGraph(g.n, g.src[b], g.dst[b], g.spec, g.vmeta_i,
                         g.vmeta_f, g.emeta_i[b], g.emeta_f[b])
    dgs, dg = [], base
    for idx in np.array_split(order[cut:], K):
        dg = append(dg, g, idx)
        dgs.append(dg)
    return base, dgs


class Streams:
    """temporal_social(400, 6000) with the bundle's columns, its warm
    stream in both packages, and the reference's cached delta runs."""

    THETA = 20

    def __init__(self):
        self.g = {pkg: labeled_graph(pkg, 400, 6000, seed=1) for pkg in MODS}
        self.streams = {pkg: warm_stream(pkg, self.g[pkg], 4) for pkg in MODS}
        self.ref = {}

    def run(self, pkg, mode, cached):
        """Per epoch: (cfg, state as numpy, stats); the cache."""
        _, _, sv, dodgr, pp, eng = MODS[pkg]
        base, dgs = self.streams[pkg]
        survey = bundle7(pkg, base.n)
        cache = dodgr.HubTableCache(base) if cached else None
        kw = {} if pkg == "ref" else dict(device="cpu")
        state, log = None, []
        for dg in dgs:
            cfg, _ = pp.plan_delta(dg, 4, survey, mode=mode,
                                   hub_theta=self.THETA, push_cap=64,
                                   pull_q_cap=8)
            gr, _ = dodgr.shard_delta(dg, 4, hub_theta=cfg.hub_theta,
                                      hub_cache=cache, **kw)
            assert gr.hub_rows == ("union" if cached else "frontier")
            state, st = eng.survey_delta(gr, survey, cfg, state)
            log.append((cfg, (ref_numpy if pkg == "ref" else state_to_numpy)(state), st))
        return log, cache

    def ref_run(self, mode):
        if mode not in self.ref:
            self.ref[mode] = self.run("ref", mode, cached=True)[0]
        return self.ref[mode]


@pytest.fixture(scope="module")
def streams():
    return Streams()


def test_hub_cache_tables_equal_reference_every_epoch(streams):
    caches = {pkg: MODS[pkg][3].HubTableCache(streams.streams[pkg][0])
              for pkg in MODS}
    for dr, dp in zip(streams.streams["ref"][1], streams.streams["pt"][1]):
        got = {}
        for pkg, dg in (("ref", dr), ("pt", dp)):
            caches[pkg].advance(dg)
            h, _ = dg.frontier()
            got[pkg] = caches[pkg].build(np.nonzero(h.degrees() >= 6)[0])
        assert got["pt"].keys() == got["ref"].keys()
        for k, want in got["ref"].items():
            if isinstance(want, np.ndarray):
                assert got["pt"][k].dtype == want.dtype, k
                np.testing.assert_array_equal(got["pt"][k], want, err_msg=k)
            else:
                assert got["pt"][k] == want, k
        for attr in ("at_epoch", "rows_reused", "rows_refreshed", "last_build"):
            assert getattr(caches["pt"], attr) == getattr(caches["ref"], attr)
        assert caches["pt"].nbytes() == caches["ref"].nbytes() > 0
    assert caches["pt"].rows_reused > 0 and caches["pt"].rows_refreshed > 0


@pytest.mark.parametrize("mode", ["push", "pushpull"])
def test_cached_delta_stream_equals_reference_and_rebuild(streams, mode):
    """K = 4 batches with HubTableCache: every epoch's state and stats
    equal the reference's; without the cache the port's states and counts
    are the same (the union rows' extra hits are old triangles, masked)."""
    ref_log = streams.ref_run(mode)
    cached, cache = streams.run("pt", mode, cached=True)
    rebuilt, _ = streams.run("pt", mode, cached=False)
    for (rc, r_state, r_st), (pc, c_state, c_st), (_, p_state, p_st) in zip(
            ref_log, cached, rebuilt):
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert pc.n_hub_steps > 0
        assert_tree_equal(r_state, c_state)
        assert c_st == r_st
        assert_tree_equal(c_state, p_state)
        for k in ("tris_push", "tris_pull", "tris_hub"):
            assert p_st[k] == c_st[k], k
    assert cache.at_epoch == 4 and cache.rows_reused > 0
    assert cache.last_build["rows_reused"] + \
        cache.last_build["rows_refreshed"] == cache.last_build["n_hubs"]


def test_cached_stream_from_empty_base_equals_one_shot(streams):
    g = streams.g["pt"]
    survey = pt_sv.SurveyBundle([pt_sv.TriangleCount(), pt_sv.ClosureTime(ts_col=0),
                                 pt_sv.TopKWeightedTriangles(4, 0)])
    base = empty_base("pt", g)
    dg = append(base, g, np.arange(g.m))
    cfg, _ = pt_pp.plan_delta(dg, 4, survey, hub_theta=Streams.THETA,
                              push_cap=64)
    gr, _ = pt_dodgr.shard_delta(dg, 4, hub_theta=cfg.hub_theta,
                                 hub_cache=pt_dodgr.HubTableCache(base),
                                 device="cpu")
    state, st = pt_engine.survey_delta(gr, survey, cfg)
    u = dg.union()
    cfg_u, _ = pt_pp.plan_engine(u, 4, survey, orient="stable",
                                 hub_theta=Streams.THETA, push_cap=64)
    gr_u, _ = pt_dodgr.shard_dodgr(u, 4, orient="stable",
                                   hub_theta=cfg_u.hub_theta, device="cpu")
    full, st_u = pt_engine.survey_push_pull(gr_u, survey, cfg_u)
    assert_tree_equal(full, pt_engine.finalize_epochs(survey, state))
    assert st["tris_hub"] > 0 and st_u["tris_hub"] > 0


def test_hub_cache_refusals(streams):
    """The stable-key requirement, epochs in order (idempotent at the
    current one), and hub tables of another hub set; the messages name
    what the reference's name."""
    base, (dg1, dg2, *_) = streams.streams["pt"]
    with pytest.raises(ValueError, match="stable"):
        pt_dodgr.HubTableCache(base, orient="degree")
    with pytest.raises(ValueError, match="stable"):
        pt_dodgr.shard_delta(dg1, 4, orient="degree", hub_theta=6,
                             hub_cache=pt_dodgr.HubTableCache(base),
                             device="cpu")
    cache = pt_dodgr.HubTableCache(base)
    with pytest.raises(ValueError, match="epoch"):
        cache.advance(dg2)
    cache.advance(dg1)
    cache.advance(dg1)
    assert cache.at_epoch == 1
    cache.advance(dg2)
    assert cache.at_epoch == 2
    h, edge_new = dg2.frontier()
    deg = h.degrees()
    assert 0 < (deg >= 20).sum() < (deg >= 6).sum()
    tables = cache.build(np.nonzero(deg >= 6)[0])
    with pytest.raises(ValueError, match="different hub set"):
        pt_dodgr.shard_dodgr(h, 4, edge_new=edge_new, orient="stable",
                             epoch=dg2.epoch, hub_theta=20,
                             hub_tables=tables, device="cpu")


def test_hub_search_refuses_a_table_past_int32_positions():
    """The hub search flattens the table to one key row addressed with
    int32 positions: a table of 2³¹ keys raises before any search (the
    reference searches row by row and has no such limit)."""
    import types

    keys = torch.zeros(1, dtype=torch.int32).expand(2**16, 2**15)
    gr = types.SimpleNamespace(S=1, e_cap=1, n_loc=1, hub_nbr=keys)
    with pytest.raises(ValueError, match="int32 positions"):
        pt_engine._hub_superstep(gr, {}, 0, None, None)
    keys = torch.zeros(1, dtype=torch.int32).expand(2**16, 2**15 - 1)
    gr.hub_nbr = keys
    with pytest.raises(AttributeError):     # past the check: no hub stream
        pt_engine._hub_superstep(gr, {}, 0, None, None)
