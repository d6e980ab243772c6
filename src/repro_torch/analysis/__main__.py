"""CLI driver: ``python -m repro_torch.analysis [contracts|plans|lint] [-S N]``
— run the three static passes over every built-in survey × transport and
exit nonzero on violations.

The matrix is the JAX package's (``python -m repro.analysis``): the 9
built-ins; each × {dense, ragged, ragged+hub, mesh, dense+bucket,
ragged+hub+bucket} × {pushpull, push} plans; and one delta epoch ×
{exact, bucket}, on the same 96-vertex labelled ``temporal_social``
graph. The folds run on small CPU tensors, the plan audit is host numpy
and the lint is AST: nothing runs on a card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.analysis import (BITWISE, builtin_surveys,
                                  check_fold_contract, check_plan,
                                  classify_determinism, format_report,
                                  lint_repo)
from repro_torch.analysis.report import Violation

PASSES = ("contracts", "plans", "lint")


def _graph(n: int = 96, m: int = 700, seed: int = 4):
    """temporal_social plus a degree vertex column and an int edge-label
    column, so every built-in survey's lanes resolve (the JAX package's
    CLI graph)."""
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import HostGraph
    from repro_torch.graphs.csr import MetaSpec as GraphSpec

    g = generators.temporal_social(n, m, seed=seed)
    spec = GraphSpec(v_int=g.spec.v_int + ("degree",), v_float=(),
                     e_int=("elabel",), e_float=g.spec.e_float)
    deg = g.degrees().astype(np.int32)
    vmeta_i = np.concatenate([g.vmeta_i, deg[:, None]], 1)
    elab = (np.arange(g.m, dtype=np.int32) % 7)[:, None]
    return HostGraph(g.n, g.src, g.dst, spec, vmeta_i, None, elab, g.emeta_f)


def run_contracts(surveys) -> list[Violation]:
    out: list[Violation] = []
    for name, s in surveys:
        out += check_fold_contract(s, name=name)
        verdict, reasons = classify_determinism(s)
        if verdict != BITWISE:
            for r in reasons:
                out.append(Violation(
                    "contracts", "non-bitwise-builtin", name,
                    f"built-in surveys must be bitwise, classified "
                    f"{verdict!r}: {r}"))
    return out


def _tagged(vs, tag: str) -> list[Violation]:
    return [Violation(v.passname, v.code, f"{tag}:{v.where}", v.message)
            for v in vs]


def run_plans(surveys, S: int = 4) -> list[Violation]:
    from repro_torch.core.pushpull import plan_delta, plan_engine
    from repro_torch.graphs.csr import HostGraph

    g = _graph()
    deg = g.degrees()
    theta = max(1, int(np.partition(deg, -8)[-8]))  # ≥ 8 delegated hubs
    cells = [
        dict(transport="dense"),
        dict(transport="ragged"),
        dict(transport="ragged", hub_theta=theta),
        dict(transport="mesh"),  # host-side audit; maps match ragged
        # bucketed plans: the cap_policy pass proves on-grid + exact-shadow
        dict(transport="dense", cap_policy="bucket"),
        dict(transport="ragged", hub_theta=theta, cap_policy="bucket"),
    ]
    out: list[Violation] = []
    for name, s in surveys:
        for cell in cells:
            for mode in ("pushpull", "push"):
                cfg, rep = plan_engine(g, S, s, mode=mode, push_cap=64,
                                       **cell)
                tag = (f"{name}/{cell['transport']}"
                       f"{'+hub' if cell.get('hub_theta') else ''}"
                       f"{'+bucket' if cell.get('cap_policy') == 'bucket' else ''}")
                out += _tagged(check_plan(cfg, rep), f"{tag}/{mode}")
    # one delta epoch (frontier plan) per cap policy, every survey
    order = np.argsort(g.emeta_f[:, 0], kind="stable")
    k = len(order) // 2
    base = HostGraph(g.n, g.src[order[:k]], g.dst[order[:k]], g.spec,
                     g.vmeta_i, g.vmeta_f, g.emeta_i[order[:k]],
                     g.emeta_f[order[:k]])
    dg = base.append_edges(g.src[order[k:]], g.dst[order[k:]],
                           emeta_i=g.emeta_i[order[k:]],
                           emeta_f=g.emeta_f[order[k:]])
    for name, s in surveys:
        for pol in ("exact", "bucket"):
            cfg, rep = plan_delta(dg, S, s, transport="ragged", push_cap=64,
                                  cap_policy=pol)
            out += _tagged(check_plan(cfg, rep),
                           f"{name}/delta{'+bucket' if pol == 'bucket' else ''}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static determinism & plan-conservation verifier of "
                    "the PyTorch port")
    ap.add_argument("passes", nargs="*",
                    help="subset of passes to run (default: all of "
                         f"{', '.join(PASSES)})")
    ap.add_argument("-S", type=int, default=4, help="shard count for plans")
    args = ap.parse_args(argv)
    for p in args.passes:
        if p not in PASSES:
            ap.error(f"unknown pass {p!r} (choose from {', '.join(PASSES)})")
    selected = args.passes or list(PASSES)

    surveys = builtin_surveys()
    violations: list[Violation] = []
    if "contracts" in selected:
        v = run_contracts(surveys)
        print(f"contracts: {len(surveys)} surveys checked, "
              f"{len(v)} violation(s)")
        violations += v
    if "plans" in selected:
        v = run_plans(surveys, S=args.S)
        print(f"plans: {len(surveys)} surveys × {{dense, ragged, "
              f"ragged+hub, mesh, dense+bucket, ragged+hub+bucket}} × "
              f"{{pushpull, push}} + delta×{{exact, bucket}} checked, "
              f"{len(v)} violation(s)")
        violations += v
    if "lint" in selected:
        v = lint_repo()
        print(f"lint: repro_torch swept, {len(v)} violation(s)")
        violations += v

    print(format_report(violations))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
