"""Render §Dry-run / §Roofline markdown tables from dry-run records — the
twin of ``repro.roofline.report``, whose tables it prints from the same
records.

    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(art_dir: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | compiles | fits HBM | peak GB/dev | "
        "flops/dev | bytes/dev | collective wire MB/dev | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ❌ | "
                         f"— | — | — | — | — | {r.get('error', '')[:60]} |")
            continue
        coll = r["collectives"]["wire_bytes"] / 1e6
        note = r.get("note", "")
        if r.get("skipped"):
            note = "UNSCORED extra: " + r["skipped"][:40]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ✅ | "
            f"{'✅' if r['fits_hbm'] else '❌'} | "
            f"{r['peak_device_bytes']/1e9:.2f} | "
            f"{r['flops_per_device']:.2e} | {r['bytes_per_device']:.2e} | "
            f"{coll:.1f} | {note[:60]} |")
    return "\n".join(lines)


def roofline_table(recs, mesh="card") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS | useful/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        t = r["terms"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"**{r['dominant'].replace('_s','')}** | "
            f"{r['model_flops_total']:.2e} | "
            f"{r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def card_table(recs) -> str:
    """One line a cell of what the card's dry run answers: fits, the
    predicted peak, FLOPs, bytes, the dominant term and its bound, and
    the roofline fraction (the two tables above in one, for one card)."""
    lines = [
        "| arch | shape | fits | peak GB | FLOPs | bytes | dominant | "
        "bound | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | ❌ "
                         f"{r.get('error', '')[:50]} | — | — | — | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{'✅' if r['fits_hbm'] else '❌'} | "
            f"{r['peak_device_bytes']/1e9:.2f} | "
            f"{r['flops_per_device']:.2e} | {r['bytes_per_device']:.2e} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{_fmt_s(r['bound_time_s'])} | {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def summarize(recs, mesh="card") -> dict:
    ok = [r for r in recs if r.get("ok")]
    fail = [r for r in recs if not r.get("ok")]
    fits = [r for r in ok if r.get("fits_hbm")]
    worst = sorted((r for r in ok if r["mesh"] == mesh),
                   key=lambda r: r.get("roofline_fraction", 0))
    coll_bound = [r for r in ok if r["mesh"] == mesh
                  and r["dominant"] == "collective_s"]
    return dict(n=len(recs), ok=len(ok), fail=len(fail), fits=len(fits),
                worst_fraction=[(r["arch"], r["shape"],
                                 round(r.get("roofline_fraction", 0), 4))
                                for r in worst[:5]],
                most_collective=[(r["arch"], r["shape"],
                                  round(r["terms"]["collective_s"]
                                        / max(1e-12, sum(r["terms"].values())), 3))
                                 for r in sorted(
                                     coll_bound,
                                     key=lambda r: -r["terms"]["collective_s"])[:5]])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    art = argv[0] if argv else "build/dryrun"
    recs = load(art)
    print("## One H100: fits, peak, FLOPs, bytes, bound\n")
    print(card_table(recs))
    print("\n## §Dry-run (all cells, one H100)\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (one H100)\n")
    print(roofline_table(recs, "card"))
    print("\n## summary\n")
    print(json.dumps(summarize(recs), indent=1))


if __name__ == "__main__":
    main()
