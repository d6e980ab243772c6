"""Streaming triangle surveys: append timestamped edge batches, poll only
the NEW triangles each epoch, and accumulate — never re-poll the snapshot.

The walkthrough: a Reddit-like comment stream arrives in batches. Epoch 1
ingests the history; each later epoch appends a batch with
``DeltaGraph.append_edges``, shards only the *delta frontier* (new edges +
old edges touching a new endpoint), and runs ``survey_delta`` — the engine
generates wedges only for the three new-triangle classes (new-old-old,
new-new-old, new-new-new) and the survey's ``merge_epochs`` folds each
epoch's answer into the running state. After K batches the accumulated
state is bitwise-identical to one full survey of the final graph, at a
fraction of the per-epoch cost.

    PYTHONPATH=src python -m repro_torch.examples.streaming_survey [--device cpu]
"""
import numpy as np

from repro_torch.core.dodgr import shard_delta, shard_dodgr
from repro_torch.core.engine import (finalize_epochs, survey_delta,
                                     survey_push_pull)
from repro_torch.core.pushpull import plan_delta, plan_engine
from repro_torch.core.surveys import ClosureTime, SurveyBundle, TriangleCount
from repro_torch.examples import cli
from repro_torch.graphs import generators
from repro_torch.graphs.csr import HostGraph


def survey():
    # re-instantiate per run: survey objects are cheap factories
    return SurveyBundle([TriangleCount(), ClosureTime(ts_col=0)])


def run(n: int = 1500, m: int = 30000, K: int = 4, batch_sz: int = 150,
        device=None) -> dict:
    S = 4
    g = generators.temporal_social(n, m, seed=11)
    order = np.argsort(g.emeta_f[:, 0], kind="stable")
    hist, tail = order[:-K * batch_sz], order[-K * batch_sz:]
    batches = np.array_split(tail, K)
    print(f"stream: {len(hist)} history edges, then {K} batches of "
          f"~{batch_sz} timestamped edges\n")

    # --- epoch 1: the history ---------------------------------------
    base = HostGraph(g.n, np.zeros(0, np.int64), np.zeros(0, np.int64),
                     g.spec, g.vmeta_i, g.vmeta_f)
    dg = base.append_edges(g.src[hist], g.dst[hist],
                           emeta_i=g.emeta_i[hist], emeta_f=g.emeta_f[hist])
    gr, _ = shard_delta(dg, S, device=device)
    cfg, _ = plan_delta(dg, S, survey(), mode="pushpull", push_cap=1024)
    state, st = survey_delta(gr, survey(), cfg)
    first = st["tris_push"] + st["tris_pull"]
    print(f"epoch 1 (history): {first:.0f} triangles")
    epochs = [dict(epoch=1, new_triangles=first)]

    # --- stream the batches ------------------------------------------
    for idx in batches:
        dg = dg.append_edges(g.src[idx], g.dst[idx],
                             emeta_i=g.emeta_i[idx], emeta_f=g.emeta_f[idx])
        h, edge_new = dg.frontier()
        gr, _ = shard_delta(dg, S, device=device)
        cfg, rep = plan_delta(dg, S, survey(), mode="pushpull", push_cap=1024)
        state, st = survey_delta(gr, survey(), cfg, state)
        running = finalize_epochs(survey(), state)
        new = st["tris_push"] + st["tris_pull"]
        print(f"epoch {dg.epoch}: +{dg.m_delta} edges → frontier {h.m} of "
              f"{dg.m} edges, {rep.gen_wedges} of {rep.wedges_total} frontier"
              f" wedges generated; +{new:.0f} "
              f"new triangles (running total "
              f"{running['TriangleCount']})")
        epochs.append(dict(epoch=dg.epoch, m_delta=dg.m_delta, frontier=h.m,
                           m=dg.m, gen_wedges=rep.gen_wedges,
                           wedges_total=rep.wedges_total, new_triangles=new,
                           running=running["TriangleCount"]))

    # --- the receipts: recompute the final snapshot from scratch -----
    res = finalize_epochs(survey(), state)
    u = dg.union()
    gr_u, _ = shard_dodgr(u, S, orient="stable", device=device)
    cfg_u, rep_u = plan_engine(u, S, survey(), mode="pushpull",
                               push_cap=1024, orient="stable")
    res_full, _ = survey_push_pull(gr_u, survey(), cfg_u)
    same_count = res["TriangleCount"] == res_full["TriangleCount"]
    same_hist = (res["ClosureTime"]["joint"]
                 == res_full["ClosureTime"]["joint"]).all()
    print(f"\nfull recompute agrees bitwise: count={same_count} "
          f"closure-histogram={bool(same_hist)}")
    print(f"final-epoch exchanged bytes: {rep.pushpull_bytes} incremental "
          f"vs {rep_u.pushpull_bytes} recompute "
          f"({rep_u.pushpull_bytes / rep.pushpull_bytes:.1f}x less)")
    close = res["ClosureTime"]["close_marginal"]
    print(f"modal closure time so far: 2^{int(np.argmax(close))} s")
    return dict(history=len(hist), epochs=epochs,
                same_count=bool(same_count), same_hist=bool(same_hist),
                incremental_bytes=rep.pushpull_bytes,
                recompute_bytes=rep_u.pushpull_bytes,
                modal_closure=int(np.argmax(close)))


def main(device=None) -> dict:
    return run(device=device)


if __name__ == "__main__":
    cli(main, __doc__)
