"""Quickstart: count triangles and survey metadata on a small graph.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from repro_torch.core.dodgr import shard_dodgr
from repro_torch.core.engine import survey_push_only, survey_push_pull
from repro_torch.core.pushpull import plan_engine
from repro_torch.core.surveys import TriangleCount
from repro_torch.examples import cli
from repro_torch.graphs import generators


def main(device=None) -> dict:
    # a scale-9 R-MAT graph (the paper's weak-scaling generator)
    g = generators.rmat(9, 16, seed=0)
    print(f"graph: {g.n} vertices, {g.m} undirected edges")

    # shard the degree-ordered directed graph over 4 logical shards
    gr, stats = shard_dodgr(g, S=4, device=device)
    print(f"DODGr: |W+| = {stats.wedges_total} wedges, "
          f"max out-degree {gr.d_plus_max}")

    # Push-Only (paper Alg. 1); the planner is survey-aware — passing the
    # survey narrows every entry to the metadata lanes it actually reads
    # (TriangleCount reads none: 6-word wedge records)
    cfg, rep = plan_engine(g, 4, TriangleCount(), mode="push")
    count, st = survey_push_only(gr, TriangleCount(), cfg)
    print(f"push-only:  {count} triangles, "
          f"{rep.push_only_bytes/1e6:.2f} MB communicated "
          f"({rep.push_entry_width} words/entry, "
          f"full metadata would be {rep.full_push_entry_width})")

    # Push-Pull (paper Sec. 4.4) — same answer, less communication
    cfg, rep2 = plan_engine(g, 4, TriangleCount(), mode="pushpull")
    count2, st = survey_push_pull(gr, TriangleCount(), cfg)
    assert count2 == count
    print(f"push-pull:  {count2} triangles, "
          f"{rep2.pushpull_bytes/1e6:.2f} MB communicated "
          f"({rep2.reduction:.1f}x reduction, "
          f"{rep2.pulls_per_rank:.0f} pulls/shard)")
    return dict(vertices=g.n, edges=g.m, wedges=stats.wedges_total,
                d_plus_max=gr.d_plus_max, push_only=count,
                push_only_bytes=rep.push_only_bytes,
                push_entry_width=rep.push_entry_width,
                full_push_entry_width=rep.full_push_entry_width,
                push_pull=count2, pushpull_bytes=rep2.pushpull_bytes,
                reduction=rep2.reduction, pulls_per_rank=rep2.pulls_per_rank)


if __name__ == "__main__":
    cli(main, __doc__)
