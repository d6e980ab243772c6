"""Paper Sec. 5.7 (Alg. 4): triangle closure-time survey on a temporal
social graph — the Reddit experiment at laptop scale.

    PYTHONPATH=src python -m repro_torch.examples.closure_survey [--device cpu]
"""
import numpy as np

from repro_torch.core.dodgr import shard_dodgr
from repro_torch.core.engine import survey_push_pull
from repro_torch.core.pushpull import plan_engine
from repro_torch.core.surveys import ClosureTime
from repro_torch.examples import cli
from repro_torch.graphs import generators


def run(n: int = 3000, m: int = 60000, device=None) -> dict:
    g = generators.temporal_social(n, m, seed=11)
    print(f"temporal graph: {g.n} users, {g.m} timestamped edges")

    gr, _ = shard_dodgr(g, S=4, device=device)
    survey = ClosureTime(ts_col=0)
    cfg, _ = plan_engine(g, 4, survey, mode="pushpull", push_cap=1024,
                         pull_q_cap=16)
    res, st = survey_push_pull(gr, survey, cfg)
    tris = int(res["joint"].sum())
    print(f"triangles surveyed: {tris} "
          f"(pushed {st['tris_push']:.0f}, pulled {st['tris_pull']:.0f})")

    close = res["close_marginal"]
    nz = np.nonzero(close)[0]
    lo, hi = nz.min(), nz.max()
    print("\nΔt_close distribution (log2-bucketed, Fig. 6 analog):")
    peak = close.max()
    for b in range(lo, hi + 1):
        bar = "#" * int(40 * close[b] / peak)
        print(f"  2^{b:>2} .. 2^{b+1:<2} | {close[b]:>8} {bar}")

    open_m = res["open_marginal"]
    print(f"\nmodal open bucket: 2^{int(np.argmax(open_m))}, "
          f"modal close bucket: 2^{int(np.argmax(close))}")
    print("(wedges form fast; closures lag with a heavy tail — "
          "the paper's qualitative Reddit finding)")
    return dict(users=g.n, edges=g.m, triangles=tris,
                tris_push=st["tris_push"], tris_pull=st["tris_pull"],
                close_marginal=[int(c) for c in close[lo:hi + 1]],
                close_lo=int(lo), modal_open=int(np.argmax(open_m)),
                modal_close=int(np.argmax(close)))


def main(device=None) -> dict:
    return run(device=device)


if __name__ == "__main__":
    cli(main, __doc__)
