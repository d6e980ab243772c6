"""The port's served mesh (``SurveyService(mesh=RankPool(S))``) against the
port's stacked service and the JAX package, on the CPU.

One pool of S = 4 gloo rank processes per module (torch at one thread,
``device="cpu"``) starts while the parent computes the JAX package's
stacked one-shot runs. One request script then drives a port service with
``mesh=pool`` and one without it: a query, a coalesced query of three
tenants, a memo hit (which sends the pool no job), a rerun, two ingested
batches (residents TriangleCount and DegreeTriples, push-only with a hub
θ), a query of the grown graph, checkpoint → ``restore(..., mesh=pool)``
→ a memo hit, a service whose ``cache_bytes`` evicts, and a sampled
(``sample_p = 0.5``) push-pull service on uniform caps. Answers, states,
tokens and the ``plan_cache_*`` / ``jit_cache_*`` counters are equal bit
for bit; the stats too (they stay far below 2²⁴, where the mesh's
per-rank float32 sums could round apart). The final answers equal the JAX
package's one-shot runs (the reference holds its mesh service equal to
its stacked one). Last, a rank killed mid-job raises in the caller, and
the pool stays broken."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import dodgr as ref_dodgr
from repro.core import engine as ref_engine
from repro.core import pushpull as ref_pp
from repro_torch.interop import state_to_numpy
from repro_torch.launch.mesh import RankPool
from repro_torch.serve import SurveyService, TenantRequest
from test_exchange import _hub_theta_for
from test_torch_delta import PKGS, append, labeled_graph
from test_torch_surveys_meta import assert_tree_equal

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

S, PUSH_CAP, PULL_Q_CAP = 4, 64, 4
SAMPLE = dict(sample_p=0.5, sample_seed=7)
COUNTERS = ("jit_cache_hits", "jit_cache_recompiles", "jit_cache_entries",
            "plan_cache_hits", "plan_cache_misses", "plan_cache_evictions",
            "plan_cache_entries", "plan_cache_bytes")


def graphs():
    """The labelled graph of tests/test_delta.py, its base (the first 80%
    of its edges by timestamp) and the two batches of the rest."""
    g = labeled_graph("pt", 96, 700, seed=4)
    order = np.argsort(g.emeta_f[:, 0], kind="stable")
    cut = int(g.m * 0.8)
    b = order[:cut]
    base = type(g)(g.n, g.src[b], g.dst[b], g.spec, g.vmeta_i, g.vmeta_f,
                   g.emeta_i[b], g.emeta_f[b])
    return g, base, np.array_split(order[cut:], 2)


def surveys(sv, n):
    """Every survey the script asks, by name, from package ``sv``."""
    return dict(
        lvc=sv.LocalVertexCount(n), tc=sv.TriangleCount(),
        ct=sv.ClosureTime(ts_col=0),
        mel=sv.MaxEdgeLabelDist(n_labels=8, e_label_col=0, v_label_col=0),
        dt=sv.DegreeTriples(deg_col=1, capacity=1 << 12))


def answer(result, stats):
    """A served answer with its stats less the wall time."""
    return result, {k: v for k, v in stats.items() if k != "plan_setup_s"}


def raw_states(svc):
    """Each cache entry's memoized state and stats, in LRU order."""
    return [(k, state_to_numpy(e.raw[0]), e.raw[1])
            for k, e in ((k, svc.cache.peek(k)) for k in svc.cache.keys())]


def drive(pool, theta, tmp):
    """The request script, on the mesh ``pool`` (or stacked, ``None``).
    Returns {step: what was answered}."""
    g, base, batches = graphs()
    sv = surveys(PKGS["pt"][2], g.n)
    kw = dict(mode="push", hub_theta=theta, push_cap=PUSH_CAP,
              transport="ragged", device="cpu", mesh=pool)
    jobs = (lambda: pool.jobs_sent) if pool is not None else (lambda: 0)
    svc = SurveyService(base, S, resident={"tc": sv["tc"], "dt": sv["dt"]},
                        **kw)
    log = {"cold": answer(*svc.query(sv["lvc"]))}
    out = svc.query_coalesced([TenantRequest("t0", sv["tc"]),
                               TenantRequest("t1", sv["ct"]),
                               TenantRequest("t2", sv["mel"])])
    log["coalesced"] = {t: answer(*out[t]) for t in out}
    before = jobs()
    log["memo"] = answer(*svc.query(sv["lvc"]))
    log["memo_jobs"] = jobs() - before
    log["rerun"] = answer(*svc.query(sv["lvc"], rerun=True))
    for k, idx in enumerate(batches):
        append(svc, g, idx)
        svc.flush()
        st = svc.ingest_stats()
        log[f"epoch{k + 1}"] = (
            svc.snapshot.token, svc.resident_answers(),
            state_to_numpy(svc.snapshot.resident_state),
            {k: v for k, v in st.items() if not k.startswith("apply_s")})
    log["grown"] = answer(*svc.query(sv["tc"]))
    log["raw"] = raw_states(svc)
    log["svc"] = svc
    path = str(tmp / f"{'mesh' if pool else 'stacked'}_ckpt.npz")
    svc.checkpoint(path)
    restored = SurveyService.restore(path, S, **kw)
    before = jobs()
    log["restored"] = (restored.epoch, restored.snapshot.token,
                       answer(*restored.query(sv["tc"])))
    log["restored_jobs"] = jobs() - before
    log["restored_rerun"] = answer(*restored.query(sv["tc"], rerun=True))
    log["restored_svc"] = restored
    restored.close()
    # a cache that holds one entry of these sizes: each new plan evicts
    small = SurveyService(base, S, mode="pushpull", transport="dense",
                          push_cap=PUSH_CAP, pull_q_cap=PULL_Q_CAP,
                          cache_bytes=1, device="cpu", mesh=pool)
    log["evicting"] = [answer(*small.query(sv[k])) for k in ("tc", "ct", "tc")]
    log["evicting_svc"] = small
    sampled = SurveyService(base, S, mode="pushpull", transport="dense",
                            push_cap=PUSH_CAP, pull_q_cap=PULL_Q_CAP,
                            device="cpu", mesh=pool, **SAMPLE)
    log["sampled"] = answer(*sampled.query(sv["tc"]))
    for s in (svc, small, sampled):
        s.close()
    return log


def reference():
    """The JAX package's stacked one-shot runs of the script's questions
    (orient="stable", as the service fixes): the base's, the grown
    graph's and the sampled base's, one bundle each."""
    ref_sv = PKGS["ref"][2]
    g, base, _ = graphs()
    g_ref = labeled_graph("ref", 96, 700, seed=4)
    b = np.argsort(g.emeta_f[:, 0], kind="stable")[:int(g.m * 0.8)]
    base_ref = type(g_ref)(g.n, g_ref.src[b], g_ref.dst[b], g_ref.spec,
                           g_ref.vmeta_i, g_ref.vmeta_f, g_ref.emeta_i[b],
                           g_ref.emeta_f[b])
    sv = surveys(ref_sv, g.n)
    theta = _hub_theta_for(base)
    runs = {"base": (base_ref, ("lvc", "tc", "ct", "mel"), "push", theta, {}),
            "grown": (g_ref, ("tc", "dt"), "push", theta, {}),
            "sampled": (base_ref, ("tc",), "pushpull", 0, SAMPLE)}
    out = {}
    for name, (gr_host, keys, mode, th, samp) in runs.items():
        bundle = ref_sv.SurveyBundle([sv[k] for k in keys], names=list(keys))
        kw = dict(mode=mode, push_cap=PUSH_CAP, pull_q_cap=PULL_Q_CAP,
                  orient="stable", hub_theta=th, **samp)
        cfg, _ = ref_pp.plan_engine(gr_host, S, bundle, **kw)
        gr, _ = ref_dodgr.shard_dodgr(gr_host, S, orient="stable",
                                      hub_theta=cfg.hub_theta, **samp)
        run = (ref_engine.survey_push_only if mode == "push"
               else ref_engine.survey_push_pull)
        out[name] = run(gr, bundle, cfg)[0]
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    with RankPool(S, device="cpu", timeout=120,
                  workdir=tmp / "ranks") as pool:
        ref = reference()             # while the ranks start
        theta = _hub_theta_for(graphs()[1])
        stacked = drive(None, theta, tmp)
        pool.log = []
        mesh = drive(pool, theta, tmp)
        mesh["pool_log"] = [job["kind"] for job, _ in pool.log]
        svcs = (mesh["svc"], mesh["evicting_svc"], mesh["restored_svc"])
        mesh["on_ranks"] = [resident(pool, svcs)]
        svcs[0].cache.invalidate(svcs[0].cache.keys()[0])
        svcs[1].cache.clear()
        mesh["on_ranks"].append(resident(pool, svcs))
        with pytest.raises(ValueError, match="mesh has 4 rank"):
            SurveyService(graphs()[1], 3, device="cpu", mesh=pool)
        mesh["wrong_size_refused"] = True
        mesh["killed"] = kill_mid_job(pool)
    yield dict(stacked=stacked, mesh=mesh, ref=ref)


def resident(pool, svcs):
    """Each service's graphs on the ranks and its cache's keys."""
    keys = pool.keys()
    return [([k for ns, k in keys if ns == s.mesh_ns], sorted(s.cache.keys()))
            for s in svcs]


def kill_mid_job(pool):
    """Kill rank 2 while the ranks hold a 30 s job: the seconds until the
    caller raises, its message, and the next call's message."""
    caught = []

    def submit():
        try:
            pool.submit(dict(kind="wait", seconds=30))
        except RuntimeError as e:
            caught.append(str(e))

    t = threading.Thread(target=submit)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.5)
    pool.procs[2].kill()
    t.join(timeout=pool.timeout + 10)
    alive = t.is_alive()
    try:
        pool.submit(dict(kind="keys"))
        again = None
    except RuntimeError as e:
        again = str(e)
    return dict(seconds=time.monotonic() - t0, alive=alive, caught=caught,
                again=again)


def counters(stats):
    return {k: stats[k] for k in COUNTERS}


# ---------------------------------------------------------------------------


def test_queries_and_tenants_equal_stacked(served):
    mesh, stacked = served["mesh"], served["stacked"]
    for step in ("cold", "memo", "rerun", "grown"):
        assert_tree_equal(stacked[step][0], mesh[step][0])
        assert mesh[step][1] == stacked[step][1], step
    for t in ("t0", "t1", "t2"):
        assert_tree_equal(stacked["coalesced"][t][0], mesh["coalesced"][t][0])
        assert mesh["coalesced"][t][1] == stacked["coalesced"][t][1], t
    assert mesh["memo"][1]["served_from"] == "memo"
    assert mesh["rerun"][1]["served_from"] == "traversal"
    assert counters(mesh["grown"][1]) == counters(stacked["grown"][1])


def test_memo_hit_sends_the_pool_no_job(served):
    mesh = served["mesh"]
    assert mesh["memo_jobs"] == 0 and mesh["restored_jobs"] == 0
    assert mesh["memo"][1]["plan_cache_hit"] == 1.0


def test_memoized_states_equal_stacked(served):
    mesh, stacked = served["mesh"], served["stacked"]
    assert [k for k, _, _ in mesh["raw"]] == [k for k, _, _ in stacked["raw"]]
    for (_, ms, mst), (_, ss, sst) in zip(mesh["raw"], stacked["raw"]):
        assert_tree_equal(ss, ms)
        assert mst == sst


@pytest.mark.parametrize("epoch", ["epoch1", "epoch2"])
def test_ingested_epochs_equal_stacked(served, epoch):
    """Tokens, resident answers and states, and the ingest counters
    (jit_cache_* included) after each batch."""
    (mt, ma, ms, mi), (st, sa, ss, si) = (served["mesh"][epoch],
                                          served["stacked"][epoch])
    assert mt == st
    assert_tree_equal(sa, ma)
    assert_tree_equal(ss, ms)
    assert mi == si


def test_restore_answers_from_memo_then_loads_on_first_traversal(served):
    mesh, stacked = served["mesh"], served["stacked"]
    assert mesh["restored"][:2] == stacked["restored"][:2]
    assert_tree_equal(stacked["restored"][2][0], mesh["restored"][2][0])
    assert mesh["restored"][2][1] == stacked["restored"][2][1]
    assert mesh["restored"][2][1]["served_from"] == "memo"
    assert_tree_equal(stacked["restored_rerun"][0], mesh["restored_rerun"][0])
    assert mesh["restored_rerun"][1] == stacked["restored_rerun"][1]
    # only the entry traversed since the restore lies on the ranks
    on_ranks, cached = mesh["on_ranks"][0][2]
    assert len(on_ranks) == 1 and on_ranks[0] in cached and len(cached) > 1


def test_ranks_hold_exactly_the_cache_keys(served):
    """The main service's graphs (epochs dropped) and the evicting
    service's (evicted entries dropped) equal their caches' keys, and
    still do after one entry is invalidated and a cache cleared."""
    mesh = served["mesh"]
    (main, evicting, _), (main_after, evicting_after, _) = mesh["on_ranks"]
    for on_ranks, cached in (main, evicting, main_after, evicting_after):
        assert on_ranks == cached
    assert mesh["evicting"][-1][1]["plan_cache_evictions"] == 2.0
    assert len(evicting[0]) == 1 and evicting_after == ([], [])
    assert len(main_after[0]) == len(main[0]) - 1
    assert "drop" in mesh["pool_log"]


def test_evicting_and_sampled_services_equal_stacked(served):
    mesh, stacked = served["mesh"], served["stacked"]
    for m, s in zip(mesh["evicting"] + [mesh["sampled"]],
                    stacked["evicting"] + [stacked["sampled"]]):
        assert_tree_equal(s[0], m[0])
        assert m[1] == s[1]
    assert mesh["sampled"][1]["sample_p"] == 0.5


def test_final_answers_equal_reference(served):
    mesh, ref = served["mesh"], served["ref"]
    for k, t in (("lvc", None), ("tc", "t0"), ("ct", "t1"), ("mel", "t2")):
        got = mesh["cold"][0] if t is None else mesh["coalesced"][t][0]
        assert_tree_equal(ref["base"][k], got)
    assert_tree_equal(ref["grown"]["tc"], mesh["grown"][0])
    assert_tree_equal(ref["grown"], mesh["epoch2"][1])
    assert_tree_equal(ref["sampled"]["tc"], mesh["sampled"][0])


def test_pool_of_another_size_is_refused(served):
    assert served["mesh"]["wrong_size_refused"]


def test_rank_killed_mid_job_raises_and_pool_stays_broken(served):
    k = served["mesh"]["killed"]
    assert not k["alive"] and k["seconds"] < 30
    assert len(k["caught"]) == 1 and "rank 2 exited" in k["caught"][0]
    assert "--- rank 2" in k["caught"][0]
    assert k["again"] is not None and "rank 2 exited" in k["again"]
