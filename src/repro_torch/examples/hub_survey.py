"""Hub delegation + ragged compaction: the two-tier exchange on a
scale-free graph.

TriPoll's headline result is communication reduction — on skewed graphs
most wedges point at a few heavy vertices, and a dense all-to-all sizes
*every* (shard, dest) buffer by the worst hub-bound stream. This
walkthrough measures the two levers the transport subsystem adds:

* ``transport="ragged"`` — each (shard, dest) pair ships its own
  planner-histogram capacity instead of the global worst case;
* ``hub_theta="auto"`` — vertices above the planner-chosen degree
  threshold θ get their ``Adj₊`` rows replicated to every shard, so
  hub-bound wedges close on the source shard at zero exchanged bytes,
  and the padded pull reply shrinks to the heaviest *surviving* row.

The survey results are bitwise-identical in every configuration — only
the bytes move.

    PYTHONPATH=src python -m repro_torch.examples.hub_survey [--device cpu]
"""
import numpy as np

from repro_torch.core.dodgr import shard_dodgr
from repro_torch.core.engine import survey_push_pull
from repro_torch.core.pushpull import plan_engine
from repro_torch.core.surveys import (SurveyBundle, TopKWeightedTriangles,
                                      TriangleCount)
from repro_torch.examples import cli
from repro_torch.graphs import generators
from repro_torch.graphs.csr import MetaSpec as GraphSpec


def survey():
    return SurveyBundle([TriangleCount(), TopKWeightedTriangles(k=8)])


def run_one(g, S, transport, hub_theta, label, device):
    cfg, rep = plan_engine(g, S, survey(), mode="pushpull",
                           transport=transport, hub_theta=hub_theta,
                           cost_model="bytes", push_cap=1024)
    gr, _ = shard_dodgr(g, S, hub_theta=cfg.hub_theta, device=device)
    res, st = survey_push_pull(gr, survey(), cfg)
    assert st["exact"] is True
    lanes = dict(push=st["wire_push_words"] * 4,
                 request=st["wire_req_words"] * 4,
                 reply=st["wire_reply_words"] * 4,
                 hub_table=rep.hub_table_bytes)
    total = sum(lanes.values())
    print(f"  {label:<12} θ={cfg.hub_theta:<4} hubs={rep.n_hubs:<3} "
          f"hub-wedges={st['wedges_hub']:>8.0f}  "
          + "  ".join(f"{k}={v / 1e6:7.3f}MB" for k, v in lanes.items())
          + f"  total={total / 1e6:7.3f}MB")
    return res, total, cfg, rep, dict(
        theta=cfg.hub_theta, hubs=rep.n_hubs, hub_wedges=st["wedges_hub"],
        total=total, **lanes)


def run(scale: int = 12, device=None) -> dict:
    S = 8
    # skewed R-MAT: the paper's weak-scaling workload, with the default
    # quadrant weights that concentrate edges on a few heavy vertices
    # (plus a random edge-weight column for the top-k survey)
    g = generators.rmat(scale, 8, seed=5, spec=GraphSpec(e_float=("w",)))
    g.emeta_f = np.random.default_rng(0).random((g.m, 1)).astype(np.float32)
    deg = g.degrees()
    print(f"rmat({scale}, 8): n={g.n} m={g.m}, degree max={deg.max()} "
          f"p99={int(np.percentile(deg, 99))} median={int(np.median(deg))}")

    print(f"\nbytes per lane, S={S} shards (measured wire buffers):")
    res_d, tot_d, _, _, row_d = run_one(g, S, "dense", 0, "dense", device)
    res_r, tot_r, _, _, row_r = run_one(g, S, "ragged", 0, "ragged", device)
    res_h, tot_h, cfg_h, rep_h, row_h = run_one(g, S, "ragged", "auto",
                                                "ragged+hub", device)
    assert res_d["TriangleCount"] == res_r["TriangleCount"] == res_h["TriangleCount"]
    assert (res_d["TopKWeightedTriangles"]["triangles"]
            == res_h["TopKWeightedTriangles"]["triangles"]).all()
    print(f"\nidentical results (count={res_d['TriangleCount']}); "
          f"ragged {tot_d / tot_r:.1f}x, ragged+hub {tot_d / tot_h:.1f}x "
          f"fewer exchanged bytes than dense")

    # --- θ sweep: delegation is a continuum between all-wire (θ=∞) and
    # all-replicated (θ→1); the planner's auto pick should sit near the knee
    print("\nθ sweep (analytic wire totals from the planner):")
    thetas = sorted({int(np.percentile(deg, p)) for p in (99.9, 99.5, 99, 97,
                                                          90, 75)} - {0})
    rows = []
    for theta in sorted(thetas, reverse=True):
        cfg, rep = plan_engine(g, S, survey(), mode="pushpull",
                               transport="ragged", hub_theta=theta,
                               cost_model="bytes", push_cap=1024)
        rows.append((theta, rep))
        print(f"  θ={theta:<5} hubs={rep.n_hubs:<4} "
              f"hub-wedges={rep.hub_resolved_wedges:<8} "
              f"hub-table={rep.hub_table_bytes / 1e6:6.3f}MB "
              f"reply-rows≤{rep.pull_row_cap:<4} "
              f"wire={rep.wire_total_bytes / 1e6:7.3f}MB")
    best = min(rows, key=lambda r: r[1].wire_total_bytes)
    print(f"\nsweep minimum at θ={best[0]} "
          f"({best[1].wire_total_bytes / 1e6:.3f}MB); planner auto chose "
          f"θ={cfg_h.hub_theta} ({rep_h.wire_total_bytes / 1e6:.3f}MB)")
    return dict(n=g.n, m=g.m, degree_max=int(deg.max()),
                count=res_d["TriangleCount"], dense=row_d, ragged=row_r,
                ragged_hub=row_h,
                sweep=[dict(theta=t, hubs=r.n_hubs,
                            hub_wedges=r.hub_resolved_wedges,
                            hub_table_bytes=r.hub_table_bytes,
                            pull_row_cap=r.pull_row_cap,
                            wire_total_bytes=r.wire_total_bytes)
                       for t, r in rows],
                best_theta=best[0], auto_theta=cfg_h.hub_theta,
                auto_wire_total_bytes=rep_h.wire_total_bytes)


def main(device=None) -> dict:
    return run(device=device)


if __name__ == "__main__":
    cli(main, __doc__)
