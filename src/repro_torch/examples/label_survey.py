"""Paper Sec. 5.8 analog: FQDN-style label-triple survey.

Vertex string labels are hashed host-side; the survey counts
distinct-label 3-tuples with the distributed counting set, and a host
dictionary un-hashes the results — the exact WDC-2012 workflow at laptop
scale.

    PYTHONPATH=src python -m repro_torch.examples.label_survey [--device cpu]
"""
import numpy as np

from repro_torch.core.dodgr import shard_dodgr
from repro_torch.core.engine import survey_push_pull
from repro_torch.core.pushpull import plan_engine
from repro_torch.core.surveys import LabelTripleSet
from repro_torch.examples import cli
from repro_torch.graphs import generators
from repro_torch.utils import splitmix32_np

DOMAINS = ["amazon.com", "abebooks.com", "audible.com", "lib.edu",
           "news.org", "shop.net", "blog.io", "wiki.org"]


def run(n: int = 2000, m: int = 40000, device=None) -> dict:
    g = generators.temporal_social(n, m, seed=13)
    # attach hashed string labels as vertex metadata (host-side dictionary)
    rng = np.random.default_rng(0)
    dom_idx = rng.integers(0, len(DOMAINS), g.n)
    hashes = splitmix32_np(np.arange(len(DOMAINS), dtype=np.uint32)).astype(np.int32)
    unhash = {int(h): d for h, d in zip(hashes, DOMAINS)}
    g.vmeta_i = hashes[dom_idx][:, None]

    gr, _ = shard_dodgr(g, S=4, device=device)
    survey = LabelTripleSet(capacity=1 << 16)
    cfg, _ = plan_engine(g, 4, survey, mode="pushpull", push_cap=1024,
                         pull_q_cap=16)
    res, _ = survey_push_pull(gr, survey, cfg)

    print(f"distinct 3-tuples: {len(res['counts'])}, "
          f"collided slots: {res['n_collided_slots']}")
    print("\ntop label triangles (Sec 5.8 'amazon.com' analysis analog):")
    top = sorted(res["counts"].items(), key=lambda kv: -kv[1])[:10]
    for key, cnt in top:
        names = tuple(unhash.get(k, f"?{k}") for k in key)
        print(f"  {cnt:>7}  {names}")

    amazon = hashes[0]
    with_amz = {k: v for k, v in res["counts"].items() if int(amazon) in k}
    print(f"\ntriangles involving amazon.com: {sum(with_amz.values())} across "
          f"{len(with_amz)} label pairs")
    return dict(distinct=len(res["counts"]),
                collided_slots=res["n_collided_slots"],
                top=[int(c) for _, c in top],
                amazon_triangles=sum(with_amz.values()),
                amazon_pairs=len(with_amz))


def main(device=None) -> dict:
    return run(device=device)


if __name__ == "__main__":
    cli(main, __doc__)
