"""Port plan_engine vs the JAX package's: EngineConfig and VolumeReport
field by field, over surveys × transports × modes × cap policies."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import generators as ref_gen
from repro_torch.core import engine as pt_engine
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import generators as pt_gen

SURVEYS = {
    "TriangleCount": (ref_sv.TriangleCount(), pt_sv.TriangleCount()),
    "DegreeTriples": (ref_sv.DegreeTriples(capacity=4096),
                      pt_sv.DegreeTriples(capacity=4096)),
}


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat9": (ref_gen.rmat(9, 16, seed=0).with_degree_meta(),
                  pt_gen.rmat(9, 16, seed=0).with_degree_meta()),
        "social": (ref_gen.temporal_social(120, 1200, seed=4),
                   pt_gen.temporal_social(120, 1200, seed=4)),
    }


def plan_both(graphs, gname, S, sname, **kw):
    g_ref, g_pt = graphs[gname]
    s_ref, s_pt = SURVEYS[sname]
    ref = ref_pp.plan_engine(g_ref, S, s_ref, **kw)
    port = pt_pp.plan_engine(g_pt, S, s_pt, **kw)
    return ref, port


def assert_plans_equal(ref, port):
    (rc, rr), (pc, pr) = ref, port
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    for prop in ("bucket_pad_fraction", "reduction", "projected_fraction",
                 "wire_total_bytes"):
        assert getattr(pr, prop) == getattr(rr, prop), prop
    assert pt_pp.plan_shape_signature(pc) == ref_pp.plan_shape_signature(rc)


@pytest.mark.parametrize("sname,transport,mode,cap_policy", list(itertools.product(
    SURVEYS, ("dense", "ragged"), ("push", "pushpull"), ("exact", "bucket"))))
def test_plan_equals_reference(graphs, sname, transport, mode, cap_policy):
    assert_plans_equal(*plan_both(graphs, "rmat9", 4, sname, mode=mode,
                                  push_cap=128, pull_q_cap=8,
                                  transport=transport, cap_policy=cap_policy))


@pytest.mark.parametrize("kw", [
    dict(pull_q_cap=None),
    dict(pull_q_cap=None, cap_policy="bucket"),
    dict(cost_model="bytes", pull_q_cap=4),
    dict(hub_theta="auto", transport="ragged", cost_model="bytes"),
    dict(hub_theta=12, pull_q_cap=None),
    dict(sample_p=0.5, sample_seed=2),
    dict(orient="stable", push_cap=3, pull_q_cap=1),
], ids=["autotune", "autotune-bucket", "bytes", "hub-auto", "hub-12",
        "sampled", "stable-tiny"])
def test_plan_options_equal_reference(graphs, kw):
    kw = dict(dict(mode="pushpull", push_cap=64), **kw)
    assert_plans_equal(*plan_both(graphs, "social", 3, "DegreeTriples", **kw))


def test_promote_from_equals_reference(graphs):
    kw = dict(mode="pushpull", push_cap=64, pull_q_cap=4, cap_policy="bucket",
              transport="ragged")
    (rc, _), (pc, _) = plan_both(graphs, "social", 3, "TriangleCount", **kw)
    grown = dict(push_cap=200, n_push_steps=9, pull_q_cap=9, n_pull_steps=7,
                 pull_row_cap=99, pull_edge_cap=500)
    rc2 = dataclasses.replace(rc, **grown)
    pc2 = dataclasses.replace(pc, **grown)
    g_ref, g_pt = graphs["social"]
    ref = ref_pp.plan_engine(g_ref, 3, SURVEYS["TriangleCount"][0],
                             promote_from=rc2, **kw)
    port = pt_pp.plan_engine(g_pt, 3, SURVEYS["TriangleCount"][1],
                             promote_from=pc2, **kw)
    assert_plans_equal(ref, port)


def test_determinism_table_equals_reference_verdicts(graphs):
    """The port stamps the fold verdict from a table until analysis/ is
    ported; it must equal what the reference's tracer stamps."""
    for sname in SURVEYS:
        (rc, _), (pc, _) = plan_both(graphs, "rmat9", 2, sname, mode="push")
        assert pc.determinism == rc.determinism == "bitwise"
    g_ref, g_pt = graphs["rmat9"]
    spec = pt_sv.MetaSpec.none()
    assert pt_pp.plan_engine(g_pt, 2, spec, mode="push")[0].determinism == "unknown"
    assert ref_pp.plan_engine(g_ref, 2, ref_sv.MetaSpec.none(),
                              mode="push")[0].determinism == "unknown"


def test_tokens_and_keys_equal_reference(graphs):
    g_ref, g_pt = graphs["social"]
    tok = ref_pp.graph_token(g_ref)
    assert pt_pp.graph_token(g_pt) == tok
    for kw in (dict(), dict(mode="push", transport="ragged", hub_theta=0,
                            sample_p=0.5, cap_policy="bucket", extra=(1, "x"))):
        assert pt_pp.plan_content_key(tok, 4, "fp", **kw) == \
            ref_pp.plan_content_key(tok, 4, "fp", **kw)
    # fingerprints are stable per content (module names differ by package)
    assert pt_pp.survey_fingerprint(pt_sv.DegreeTriples(capacity=64)) == \
        pt_pp.survey_fingerprint(pt_sv.DegreeTriples(capacity=64))
    assert pt_pp.survey_fingerprint(pt_sv.DegreeTriples(capacity=64)) != \
        pt_pp.survey_fingerprint(pt_sv.DegreeTriples(capacity=128))


def test_private_helpers_equal_reference():
    rng = np.random.default_rng(0)
    for bucket in (False, True):
        for _ in range(20):
            per_sd = rng.integers(0, 300, 16)
            args = (per_sd, 4, 3, int(rng.integers(1, 900)))
            assert pt_pp._autotune_pull_q_cap(*args, bucket=bucket) == \
                ref_pp._autotune_pull_q_cap(*args, bucket=bucket)
    n = 200
    tdeg = rng.integers(0, 60, n)
    d_plus = rng.integers(0, 30, n)
    vol = rng.integers(0, 500, n)
    req = rng.integers(0, 4, n)
    for max_hubs in (0, 5, 50):
        args = (tdeg, d_plus, vol, req, (7, 4, 3, 2), 4, 6, 3, max_hubs)
        assert pt_pp._choose_hub_theta(*args) == ref_pp._choose_hub_theta(*args)


def test_engine_config_defaults_equal_reference():
    from repro.core.engine import EngineConfig as RefConfig

    assert dataclasses.asdict(pt_engine.EngineConfig()) == \
        dataclasses.asdict(RefConfig())
