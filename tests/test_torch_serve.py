"""The port's serve layer (``repro_torch.serve``) against the JAX
package's (``repro.serve``) on the CPU.

One reference service and one port service on temporal_social(120, 1200,
seed=3), S=4, hub_theta=5, push_cap=64, with residents TriangleCount and
ClosureTime, are built once and driven through one request script: a
cold, warm and rerun query; a coalesced query of four tenants and the
tenants' solo queries; three ingested batches whose planned caps drift
inside one bucket (tests/test_bucketing.py's drifting-caps case, held
against an exact-policy twin); a query of the grown snapshot; a
checkpoint and a restore. Answers, stats (timings aside), tokens and the
``jit_cache_*`` / ``plan_cache_*`` counters equal the reference's after
every step, and the answers equal the port's one-shot surveys. Plan files
written by either package load into the other. Exact equality
throughout."""
import dataclasses
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.core import dodgr as ref_dodgr
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import generators as ref_gen
from repro_torch import serve as pt_serve
from repro_torch.core import dodgr as pt_dodgr
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import generators as pt_gen
from repro_torch.interop import shards_to_arrays, state_to_numpy
from repro_torch.serve import service as pt_service
from test_torch_contracts import PtFloatAdd, RefFloatAdd
from test_torch_surveys_meta import assert_tree_equal, ref_numpy

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

MODS = {"ref": (ref_serve, ref_sv, ref_gen), "pt": (pt_serve, pt_sv, pt_gen)}
S, THETA, PUSH_CAP = 4, 5, 64
# batch sizes whose bucketed caps drift: the second epoch reuses the
# first's shapes, the third does not (test_bucketing.py's case, scaled)
DRIFT = (40, 32, 34)
COUNTERS = ("jit_cache_hits", "jit_cache_recompiles", "jit_cache_entries",
            "plan_cache_hits", "plan_cache_misses", "plan_cache_evictions",
            "plan_cache_entries", "plan_cache_bytes")
INGEST_KEYS = ("epochs_applied", "pending", "epoch", "jit_cache_hits",
               "jit_cache_recompiles", "jit_cache_entries", "batches_applied",
               "hub_rows_reused", "hub_rows_refreshed", "hub_last_build")


def graph(pkg, n=120, m=1200, seed=3):
    return MODS[pkg][2].temporal_social(n, m, seed=seed)


def residents(pkg):
    sv = MODS[pkg][1]
    return {"tc": sv.TriangleCount(), "ct": sv.ClosureTime(ts_col=0)}


def service(pkg, g, **kw):
    kw = dict(dict(hub_theta=THETA, push_cap=PUSH_CAP), **kw)
    if pkg == "pt":
        kw["device"] = "cpu"
    return MODS[pkg][0].SurveyService(g, S, **kw)


def tenants(pkg, n):
    sv, T = MODS[pkg][1], MODS[pkg][0].TenantRequest
    return [T("t0", sv.TriangleCount()), T("t1", sv.ClosureTime(ts_col=0)),
            T("t2", sv.LocalVertexCount(n)), T("t3", sv.TriangleCount())]


def batch(pkg, k):
    return graph(pkg, 120, DRIFT[k], seed=50 + k)


def answer(result, stats):
    """A served answer with its stats less the wall time."""
    return result, {k: v for k, v in stats.items() if k != "plan_setup_s"}


def ingest_counters(svc):
    st = svc.ingest_stats()
    return {k: st.get(k) for k in INGEST_KEYS}


def drive(pkg, tmp):
    """The request script. Returns {step: what was answered} and the
    service (open)."""
    sv = MODS[pkg][1]
    g = graph(pkg)
    svc = service(pkg, g, resident=residents(pkg))
    log = {"warmup": ingest_counters(svc)}
    lvc = sv.LocalVertexCount(g.n)
    log["cold"] = answer(*svc.query(lvc))
    log["warm"] = answer(*svc.query(sv.LocalVertexCount(g.n)))
    log["rerun"] = answer(*svc.query(lvc, rerun=True))
    reqs = tenants(pkg, g.n)
    out = svc.query_coalesced(reqs)
    log["coalesced"] = {t: answer(*out[t]) for t in out}
    log["solo"] = {r.tenant: answer(*svc.query(r.survey)) for r in reqs}
    log["entries"] = [(e.nbytes, e.cfg, e.report) for e in
                      (svc.cache.peek(k) for k in svc.cache.keys())]
    for k in range(len(DRIFT)):
        b = batch(pkg, k)
        svc.append_edges(b.src, b.dst, emeta_i=b.emeta_i, emeta_f=b.emeta_f)
        svc.flush()
        log[f"epoch{k + 1}"] = (ingest_counters(svc), svc.snapshot.token,
                                svc.resident_answers(),
                                svc.snapshot.jit_hits,
                                svc.snapshot.jit_recompiles)
    log["grown"] = answer(*svc.query(sv.TriangleCount()))
    path = str(tmp / f"{pkg}_ckpt.npz")
    svc.checkpoint(path)
    restored = MODS[pkg][0].SurveyService.restore(
        path, S, hub_theta=THETA, push_cap=PUSH_CAP,
        **({"device": "cpu"} if pkg == "pt" else {}))
    log["restored"] = (restored.epoch, restored.snapshot.token,
                       answer(*restored.query(sv.TriangleCount())),
                       ingest_counters(restored))
    restored.close()
    log["ckpt"] = path
    return log, svc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    logs, svcs = {}, {}
    for pkg in MODS:
        logs[pkg], svcs[pkg] = drive(pkg, tmp)
    yield logs, svcs
    for s in svcs.values():
        s.close()


def oneshot(g, survey):
    """The port's one-shot stable-key survey with the service's plan."""
    cfg, _ = pt_pp.plan_engine(g, S, survey, orient="stable",
                               hub_theta=THETA, push_cap=PUSH_CAP,
                               cap_policy="bucket")
    gr, _ = pt_dodgr.shard_dodgr(g, S, orient="stable",
                                 hub_theta=cfg.hub_theta, device="cpu")
    return pt_engine.survey_push_pull(gr, survey, cfg)[0]


# ---------------------------------------------------------------------------
# queries


def test_warm_equals_cold_equals_oneshot_and_reference(served):
    logs, _ = served
    pt, ref = logs["pt"], logs["ref"]
    assert pt["warmup"] == ref["warmup"]
    assert pt["warmup"]["jit_cache_recompiles"] == 1
    for step in ("cold", "warm", "rerun"):
        assert_tree_equal(ref[step][0], pt[step][0])
        assert pt[step][1] == ref[step][1], step
        assert_tree_equal(pt["cold"][0], pt[step][0])
    assert pt["cold"][1]["plan_cache_hit"] == 0.0
    assert pt["warm"][1]["plan_cache_hit"] == 1.0
    assert pt["warm"][1]["served_from"] == "memo"
    assert pt["rerun"][1]["served_from"] == "traversal"
    rerun = pt["rerun"][1]
    assert (rerun["jit_cache_hits"], rerun["jit_cache_recompiles"]) == (1.0, 2.0)
    g = graph("pt")
    assert_tree_equal(oneshot(g, pt_sv.LocalVertexCount(g.n)), pt["cold"][0])


def test_coalesced_equals_solo_and_reference(served):
    logs, _ = served
    pt, ref = logs["pt"], logs["ref"]
    g = graph("pt")
    for req in tenants("pt", g.n):
        t = req.tenant
        res, stats = pt["coalesced"][t]
        assert_tree_equal(ref["coalesced"][t][0], res)
        assert stats == ref["coalesced"][t][1]
        assert stats["coalesced"] == 4 and stats["tenant"] == t
        assert_tree_equal(pt["solo"][t][0], res)
        assert pt["solo"][t][1] == ref["solo"][t][1]
        assert_tree_equal(oneshot(g, req.survey), res)
    # the second TriangleCount and the LocalVertexCount solos are memo
    # hits of earlier queries
    assert pt["solo"]["t3"][1]["served_from"] == "memo"
    assert pt["solo"]["t2"][1]["served_from"] == "memo"
    for key in COUNTERS:
        assert pt["solo"]["t3"][1][key] == ref["solo"]["t3"][1][key], key


def test_extract_and_coalesce_follow_reference():
    for pkg in MODS:
        srv, sv = MODS[pkg][0], MODS[pkg][1]
        reqs = [srv.TenantRequest("a", sv.TriangleCount()),
                srv.TenantRequest("b", sv.TriangleCount())]
        out = srv.extract({"a": 1, "b": 2}, {"x": 0.0}, reqs)
        assert out["a"] == (1, {"x": 0.0, "coalesced": 2, "tenant": "a"})
        assert out["a"][1] is not out["b"][1]
        with pytest.raises(KeyError):
            srv.extract({"a": 1}, {}, reqs)
        with pytest.raises(ValueError, match="duplicate tenant"):
            srv.coalesce([reqs[0], reqs[0]])
        with pytest.raises(ValueError, match="at least one"):
            srv.coalesce([])
        assert srv.coalesce(reqs).names == ("a", "b")


def test_order_sensitive_warning_follows_reference():
    """A coalesced bundle with a float scatter-add member is stamped
    order_sensitive by both planners and warns with the same message; a
    bitwise bundle does not warn."""
    got = {}
    for pkg, fl in (("ref", RefFloatAdd()), ("pt", PtFloatAdd())):
        srv, sv = MODS[pkg][0], MODS[pkg][1]
        pp = ref_pp if pkg == "ref" else pt_pp
        g = graph(pkg)
        for name, members in (("float", [fl, sv.TriangleCount()]),
                              ("count", [sv.TriangleCount()])):
            reqs = [srv.TenantRequest(f"t{i}", s) for i, s in enumerate(members)]
            cfg, _ = pp.plan_engine(g, S, srv.coalesce(reqs), orient="stable",
                                    push_cap=PUSH_CAP)
            mod = sys.modules[f"{srv.__name__}.coalesce"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                mod.warn_if_order_sensitive(cfg, reqs)
            got[pkg, name] = cfg.determinism, [str(w.message) for w in caught]
    for name in ("float", "count"):
        assert got["pt", name] == got["ref", name]
    assert got["pt", "float"][0] == "order_sensitive"
    (message,) = got["pt", "float"][1]
    assert "2 tenants" in message
    assert got["pt", "count"] == ("bitwise", [])


# ---------------------------------------------------------------------------
# the plan cache


def test_entry_nbytes_and_plans_equal_reference(served):
    logs, svcs = served
    pt, ref = logs["pt"]["entries"], logs["ref"]["entries"]
    assert len(pt) == len(ref) == 5
    for (pn, pc, pr), (rn, rc, rr) in zip(pt, ref):
        assert pn == rn > 0
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    e = svcs["pt"].cache.peek(svcs["pt"].cache.keys()[0])
    arrays, _ = shards_to_arrays(e.gr)
    assert pt_serve.entry_nbytes(e.gr) == sum(a.nbytes for a in arrays.values())


def test_plan_cache_eviction_order_equals_reference(served):
    """The LRU under a byte budget of the first two real entries' bytes:
    the same entries go, in the same order, with the same counters."""
    logs, _ = served
    sizes = [n for n, _, _ in logs["pt"]["entries"]]
    trace = {}
    for pkg in MODS:
        srv = MODS[pkg][0]
        c = srv.PlanCache(byte_budget=sizes[0] + sizes[1])
        seen = []

        def put(key, nbytes):
            c.insert(srv.CacheEntry(key=key, nbytes=nbytes))
            seen.append((key, tuple(c.keys()), c.stats()))

        put("a", sizes[0])
        put("b", sizes[1])
        assert c.lookup("a") is not None and c.lookup("zz") is None
        put("c", sizes[2])            # over budget: b, the LRU, goes
        put("d", sizes[3])
        put("big", sum(sizes))        # alone over budget: kept
        put("e", sizes[4])            # and dropped at the next insert
        trace[pkg] = seen
    assert trace["pt"] == trace["ref"]
    assert trace["pt"][2][1] == ("a", "c")
    assert trace["pt"][4][1] == ("big",) and trace["pt"][5][1] == ("e",)


def _entries_equal(ref_entries, pt_entries):
    assert len(pt_entries) == len(ref_entries)
    for r, p in zip(ref_entries, pt_entries):
        assert (p.key, p.nbytes, p.uses, p.survey_fp) == \
            (r.key, r.nbytes, r.uses, r.survey_fp)
        assert p.fn is None and p.survey is None
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(r.cfg)
        assert dataclasses.asdict(p.report) == dataclasses.asdict(r.report)
        arrays, meta = shards_to_arrays(p.gr)
        assert meta == {f: getattr(r.gr, f) for f in ref_dodgr.META_FIELDS}
        for f, a in arrays.items():
            want = np.asarray(getattr(r.gr, f))
            assert a.dtype == want.dtype and a.shape == want.shape, f
            np.testing.assert_array_equal(a, want, err_msg=f)
        assert_tree_equal(ref_numpy(r.raw[0]), state_to_numpy(p.raw[0]))
        assert p.raw[1] == {k: float(v) for k, v in r.raw[1].items()}


def test_plan_files_load_in_either_package(served):
    """A ``.plans.npz`` written by either package loads into the other:
    keys, configs, reports, shards (uint32 hashes as uint32), memoized
    states (uint32 limbs as uint32) and float32 stats equal the writer's
    entries read back by the writer's own package."""
    logs, _ = served
    for src, dst in (("ref", "pt"), ("pt", "ref")):
        path = pt_service._plans_path(logs[src]["ckpt"])
        ref_entries = ref_serve.load_plan_cache(path)
        pt_entries = pt_serve.load_plan_cache(path, device="cpu")
        _entries_equal(ref_entries, pt_entries)
        assert len(pt_entries) == 6
    # the port writes the reference's member names and dtypes
    with np.load(pt_service._plans_path(logs["pt"]["ckpt"])) as zp, \
            np.load(pt_service._plans_path(logs["ref"]["ckpt"])) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for f in zr.files:
            assert zp[f].dtype == zr[f].dtype and zp[f].shape == zr[f].shape, f
    # into a cache, oldest first
    fresh = pt_serve.PlanCache()
    pt_serve.load_plan_cache(path, into=fresh, device="cpu")
    assert fresh.stats()["entries"] == 6


# ---------------------------------------------------------------------------
# ingestion, bucketing, restore


def test_ingested_epochs_equal_reference(served):
    """After each of the three batches: the counters, the token chain, the
    resident answers and the snapshot's counters equal the reference's;
    at the end the residents equal one-shot surveys of the union."""
    logs, svcs = served
    for k in range(len(DRIFT)):
        p, r = logs["pt"][f"epoch{k + 1}"], logs["ref"][f"epoch{k + 1}"]
        assert p[0] == r[0]
        assert p[1] == r[1]
        assert_tree_equal(r[2], p[2])
        assert p[3:] == r[3:]
        assert p[0]["epochs_applied"] == p[0]["epoch"] == k + 1
    assert logs["pt"]["epoch3"][0]["hub_rows_reused"] > 0
    u = svcs["pt"].snapshot.union
    for name, survey in residents("pt").items():
        assert_tree_equal(oneshot(u, survey),
                          logs["pt"]["epoch3"][2][name])
    res, stats = logs["pt"]["grown"]
    assert_tree_equal(logs["ref"]["grown"][0], res)
    assert stats == logs["ref"]["grown"][1]
    assert stats["served_epoch"] == 3.0
    assert res == oneshot(u, pt_sv.TriangleCount())


def recompiles_per_epoch(log):
    """The recompiles each ingested epoch added."""
    before = log["solo"]["t3"][1]["jit_cache_recompiles"]
    rc = [log[f"epoch{k + 1}"][0]["jit_cache_recompiles"]
          for k in range(len(DRIFT))]
    return [b - a for a, b in zip([before] + rc, rc)]


def test_drifting_caps_reuse_like_reference(served):
    """test_bucketing.py's drifting-caps case: under ``cap_policy="bucket"``
    the second epoch reuses the first's function and shapes (no
    recompile) and the third does not, in both packages; the port's
    exact-policy twin recompiles every epoch and renders the same
    answers."""
    logs, _ = served
    rc = {pkg: recompiles_per_epoch(logs[pkg]) for pkg in MODS}
    assert rc["pt"] == rc["ref"] == [1, 0, 1]
    with service("pt", graph("pt"), resident=residents("pt"),
                 cap_policy="exact") as svc:
        rc_e = []
        for k in range(len(DRIFT)):
            before = svc.ingest_stats()["jit_cache_recompiles"]
            b = batch("pt", k)
            svc.append_edges(b.src, b.dst, emeta_i=b.emeta_i,
                             emeta_f=b.emeta_f, wait=True)
            rc_e.append(svc.ingest_stats()["jit_cache_recompiles"] - before)
        assert rc_e == [1, 1, 1]
        assert_tree_equal(logs["pt"]["epoch3"][2], svc.resident_answers())


def test_restore_continues_token_chain_and_answers_from_memo(served):
    logs, svcs = served
    p, r = logs["pt"]["restored"], logs["ref"]["restored"]
    assert p[0] == r[0] == 3
    assert p[1] == r[1] == svcs["pt"].snapshot.token
    assert_tree_equal(r[2][0], p[2][0])
    assert p[2][1] == r[2][1]
    assert p[2][1]["plan_cache_hit"] == 1.0 and p[2][1]["served_from"] == "memo"
    assert p[2][1]["jit_cache_recompiles"] == 0.0     # no traversal
    assert p[3] == r[3]
    assert_tree_equal(logs["pt"]["grown"][0], p[2][0])
    # the reference's checkpoint restores into the port: same epoch and
    # token chain
    svc = pt_serve.SurveyService.restore(logs["ref"]["ckpt"], S,
                                         hub_theta=THETA, push_cap=PUSH_CAP,
                                         device="cpu")
    try:
        assert svc.epoch == 3 and svc.snapshot.token == r[1]
        assert len(svc.cache) == 6
    finally:
        svc.close()


def test_worker_error_surfaces_on_flush_and_sampling_refusal():
    g = graph("pt")
    with pt_serve.SurveyService(g, S, push_cap=PUSH_CAP, device="cpu") as svc:
        svc.append_edges(np.array([0]), np.array([1]),
                         emeta_i=np.zeros((1, 99), np.int32))  # bad width
        with pytest.raises(RuntimeError, match="ingest worker failed"):
            svc.flush()
    with pytest.raises(ValueError, match="resident"):
        pt_serve.SurveyService(g, S, sample_p=0.5, device="cpu",
                               resident={"tc": pt_sv.TriangleCount()})


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_serve.SurveyService(graph("pt"), S)


def test_compile_cache_dir_keeps_the_kernel_builds(monkeypatch, tmp_path):
    from repro_torch.kernels import _cuda

    monkeypatch.setattr(_cuda, "BUILD_ROOT", _cuda.BUILD_ROOT)
    assert pt_serve.enable_persistent_compilation_cache(tmp_path)
    assert _cuda.build_dir().parent == tmp_path


def test_queries_answer_from_whole_snapshots_during_ingest():
    """Queries issued while batches are pending answer from the last
    merged snapshot (two queries at one epoch agree), and every function
    call is counted once, as a hit or a recompile."""
    g = graph("pt")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    svc = pt_serve.SurveyService(g, S, push_cap=PUSH_CAP, device="cpu",
                                 resident={"tc": pt_sv.TriangleCount()})
    try:
        stop, seen = threading.Event(), []

        def hammer():
            while not stop.is_set():
                res, stats = svc.query(pt_sv.TriangleCount())
                seen.append((int(stats["served_epoch"]), res))

        t = threading.Thread(target=hammer)
        t.start()
        rng = np.random.default_rng(5)
        for _ in range(2):
            e = rng.integers(0, g.n, size=(25, 2))
            svc.append_edges(
                e[:, 0], e[:, 1],
                emeta_i=np.zeros((25, g.emeta_i.shape[1]), np.int32),
                emeta_f=rng.random((25, g.emeta_f.shape[1])).astype(np.float32))
        svc.flush()
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        by_epoch = {}
        for ep, res in seen:
            assert by_epoch.setdefault(ep, res) == res, f"torn epoch {ep}"
        assert seen and set(by_epoch) <= {0, 1, 2}
        st = svc.ingest_stats()
        # one warm-up, two delta epochs and one traversal per queried epoch
        assert st["jit_cache_hits"] + st["jit_cache_recompiles"] == \
            3 + len(by_epoch)
        assert by_epoch.get(2, svc.query(pt_sv.TriangleCount())[0]) == \
            svc.resident_answers()["tc"]
    finally:
        sys.setswitchinterval(interval)
        svc.close()
