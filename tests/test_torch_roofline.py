"""The port's mesh byte model (``repro_torch.roofline``) against the JAX
package's: ``mesh_collective_plan`` equal on every shared field for a
ragged and a uniform mesh plan, push-pull and push-only; the padding
identities; and ``reconcile_collectives`` on counters made from the plan:
exact lanes pass, an unknown lane, a short lane or a rank over its
schedule fail, and the state all-gather is reported, not reconciled. The
counters of real rank processes: tests/test_torch_mesh.py."""
import dataclasses

import pytest
import torch

from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import generators as ref_gen
from repro.roofline import mesh_collective_plan as ref_plan
from repro_torch.comm.exchange import make_exchange
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import generators as pt_gen
from repro_torch.roofline import HW, mesh_collective_plan, reconcile_collectives

torch.set_num_threads(1)

S = 8
KW = dict(push_cap=512, pull_q_cap=16)
SHARED = ("per_kind", "lanes", "total_bytes", "per_device_bytes",
          "n_devices", "padding_rounds", "schedules")


def _plans(kind, mode):
    """(reference cfg, port cfg, port report) of a hub-skewed R-MAT at
    S = 8: a mesh plan (ragged caps) or a dense plan relabelled mesh
    (uniform caps)."""
    transport = "mesh" if kind == "ragged" else "dense"
    out = []
    for pp, sv, gen in ((ref_pp, ref_sv, ref_gen), (pt_pp, pt_sv, pt_gen)):
        g = gen.rmat(9, 16, seed=5, a=0.75, b=0.055, c=0.055)
        cfg, rep = pp.plan_engine(g, S, sv.TriangleCount(), mode=mode,
                                  transport=transport, **KW)
        out.append((dataclasses.replace(cfg, transport="mesh"), rep))
    return out[0][0], out[1][0], out[1][1]


@pytest.fixture(scope="module")
def plans():
    return {(k, m): _plans(k, m) for k in ("ragged", "uniform")
            for m in ("pushpull", "push")}


@pytest.mark.parametrize("mode", ["pushpull", "push"])
@pytest.mark.parametrize("kind", ["ragged", "uniform"])
def test_plan_equals_reference_on_shared_fields(plans, kind, mode):
    ref_cfg, cfg, _ = plans[(kind, mode)]
    want, got = ref_plan(ref_cfg, S=S), mesh_collective_plan(cfg, S=S)
    for key in SHARED:
        assert got[key] == want[key], key
    assert (set(got["per_kind"]) == {"all-to-all"}) == (kind == "uniform")
    assert bool(got["schedules"]) == (kind == "ragged")


@pytest.mark.parametrize("kind", ["ragged", "uniform"])
def test_sent_bytes_and_padding_identities(plans, kind):
    """sent bytes per lane = steps · sent_round_slots · words · 4; uniform
    caps send exactly the model's (and the report's) bytes; each padding
    breakdown sums to its total less the report's wire bytes."""
    cfg, rep = plans[(kind, "pushpull")][1:]
    plan = mesh_collective_plan(cfg, S=S)
    w_push, w_row, w_hdr, w_req = cfg.meta_widths
    push = make_exchange("mesh", S, cfg.push_cap, cfg.push_caps)
    assert (plan["sent_bytes"]["push"]
            == cfg.n_push_steps * push.sent_round_slots() * w_push * 4)
    logical = rep.wire_push_bytes + rep.wire_req_bytes + rep.wire_reply_bytes
    assert (sum(e["bytes"] for e in plan["padding_rounds"])
            == plan["total_bytes"] - logical)
    assert (sum(e["bytes"] for e in plan["sent_padding_rounds"])
            == plan["sent_total_bytes"] - logical)
    if kind == "uniform":
        assert plan["sent_bytes"] == plan["lanes"]
        assert plan["sent_total_bytes"] == logical
    else:
        assert plan["sent_total_bytes"] < plan["total_bytes"]
    rec = reconcile_collectives(dict(plan["sent_bytes"], merge=96), cfg,
                                S=S, volume=rep)
    assert rec["ok"] and rec["padding_ok"], rec["lanes"]
    assert rec["other_bytes"] == 96 and rec["extra_bytes"] == 0
    assert rec["padding_bytes"] == plan["sent_total_bytes"] - logical
    assert sum(r["padding"] for r in rec["lanes"].values()) == rec["padding_bytes"]


def test_reconcile_fails_on_unknown_short_or_overfull_lanes(plans):
    cfg, rep = plans[("ragged", "pushpull")][1:]
    plan = mesh_collective_plan(cfg, S=S)
    sent = plan["sent_bytes"]
    rec = reconcile_collectives(dict(sent, push_back=64), cfg, S=S)
    assert not rec["ok"] and rec["extra_lanes"] == {"push_back": 64}
    short = dict(sent, reply=sent["reply"] - 4)
    rec = reconcile_collectives(short, cfg, S=S, volume=rep)
    assert not rec["ok"] and not rec["lanes"]["reply"]["ok"]
    assert rec["lanes"]["push"]["ok"]
    # the same total on one rank: within the sum, over the schedule
    ranks = [dict(sent)] + [dict(push=0, req=0, reply=0)] * (S - 1)
    rec = reconcile_collectives(ranks, cfg, S=S)
    assert not rec["ok"]
    assert rec["lanes"]["push"]["rank_max"] > rec["lanes"]["push"]["per_device"]


def test_hw_constants():
    """The card's data-sheet rates; the kernel bounds' two (device memory
    rate, int32 operations) at the values the kernel table's bounds were
    computed with."""
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert hw.peak_int32_ops == 67e12
