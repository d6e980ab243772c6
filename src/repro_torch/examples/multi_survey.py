"""Multi-survey polling: N questions, ONE traversal (SurveyBundle), plus the
two workloads it unlocks — top-weighted triangle retrieval (Kumar et al.)
and DOULION sampled approximate counting (Tsourakakis et al.).

    PYTHONPATH=src python -m repro_torch.examples.multi_survey [--device cpu]
"""
import numpy as np

from repro_torch.core.dodgr import shard_dodgr, sparsify_edges
from repro_torch.core.engine import survey_push_pull
from repro_torch.core.pushpull import plan_engine
from repro_torch.core.surveys import (ClosureTime, LabelTripleSet, SurveyBundle,
                                      TopKWeightedTriangles, TriangleCount)
from repro_torch.examples import cli
from repro_torch.graphs import generators


def run(n: int = 2000, m: int = 40000, device=None) -> dict:
    g = generators.temporal_social(n, m, seed=11)
    print(f"temporal graph: {g.n} users, {g.m} timestamped edges")

    S = 4
    gr, _ = shard_dodgr(g, S=S, device=device)

    # --- one pass, four questions -------------------------------------
    bundle = SurveyBundle([
        TriangleCount(),
        ClosureTime(ts_col=0),
        LabelTripleSet(capacity=1 << 14),
        TopKWeightedTriangles(k=5, weight_col=0),
    ])
    # survey-aware plan: entries carry only the union of the members'
    # declared metadata lanes
    cfg, rep = plan_engine(g, S, bundle, mode="pushpull", push_cap=1024,
                           pull_q_cap=16)
    print(f"push entries: {rep.push_entry_width} words projected "
          f"(full metadata: {rep.full_push_entry_width})")
    res, st = survey_push_pull(gr, bundle, cfg)
    print(f"\none traversal ({st['wedges_pushed']:.0f} wedges pushed, "
          f"{st['pull_requests']:.0f} rows pulled) answered "
          f"{int(st['n_surveys'])} surveys:")

    print(f"  triangles: {res['TriangleCount']}")
    close = res["ClosureTime"]["close_marginal"]
    print(f"  modal closure time: 2^{int(np.argmax(close))} s")
    counts = res["LabelTripleSet"]["counts"]
    top_lab = max(counts, key=counts.get) if counts else None
    print(f"  distinct label triples: {len(counts)} (most common {top_lab})")
    topk = res["TopKWeightedTriangles"]
    print("  heaviest triangles (by Σ edge ts — latest-closing):")
    for w, (p, q, r) in zip(topk["weights"], topk["triangles"]):
        print(f"    ({p}, {q}, {r})  weight {w:.0f}")

    # --- sampled approximate counting ---------------------------------
    # sparsify ONCE; the stamped graph feeds ingestion and planning with
    # no second sampling pass and full provenance checking
    p = 0.25
    g_s = sparsify_edges(g, p, 1)
    gr_s, _ = shard_dodgr(g_s, S=S, device=device)
    cfg_s, _ = plan_engine(g_s, S, TriangleCount(), mode="pushpull",
                           push_cap=1024, pull_q_cap=16)
    est, st_s = survey_push_pull(gr_s, TriangleCount(), cfg_s)
    err = abs(est - res["TriangleCount"]) / res["TriangleCount"]
    print(f"\nDOULION p={p}: estimate {est:.0f} vs exact "
          f"{res['TriangleCount']} ({err:.1%} error, "
          f"predicted rel-stderr {st_s['sample_rel_stderr']:.1%})")
    return dict(users=g.n, edges=g.m, push_entry_width=rep.push_entry_width,
                full_push_entry_width=rep.full_push_entry_width,
                wedges_pushed=st["wedges_pushed"],
                pull_requests=st["pull_requests"],
                n_surveys=int(st["n_surveys"]),
                triangles=res["TriangleCount"],
                modal_closure=int(np.argmax(close)),
                distinct_label_triples=len(counts), most_common=top_lab,
                top_weights=[float(w) for w in topk["weights"]],
                top_triangles=[tuple(int(x) for x in t)
                               for t in topk["triangles"]],
                estimate=float(est), error=float(err),
                rel_stderr=st_s["sample_rel_stderr"])


def main(device=None) -> dict:
    return run(device=device)


if __name__ == "__main__":
    cli(main, __doc__)
