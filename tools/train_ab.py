#!/usr/bin/env python3
"""Time an earlier tree's LM training steps against this tree's, on one GPU.

    git archive <commit> | tar -x -C build/old     # the earlier tree
    python3 tools/train_ab.py build/old [--pairs 10] [--steps 12]

Each run is ``python -m repro_torch.launch.train --arch internlm2-1.8b
--steps STEPS --batch 8 --seq 2049 --log-every 1`` in a fresh process from
one tree's root (the full-width step of ``chip_smoke.py``'s path l), its
step walls read from the lines ``launch.train`` prints. Runs go in blocks
of earlier, this, this, earlier, ``--pairs`` pairs in all, so both trees
meet the same drift of the card and its host. Each run's walls and the
median of its steps after the first are printed and written to
``build/train_ab.json`` with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEP = re.compile(r"step +\d+ loss [\d.]+ +([\d.]+) ms")


def run(tree: Path, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH="src")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--steps", str(steps), "--batch", "8", "--seq",
         "2049", "--log-every", "1"],
        cwd=tree, env=env, capture_output=True, text=True)
    walls = [float(m.group(1)) / 1e3 for m in map(STEP.search,
                                                   p.stdout.splitlines()) if m]
    out = dict(rc=p.returncode, walls=walls,
               process_s=time.perf_counter() - t0,
               median=statistics.median(walls[1:]) if len(walls) > 1 else None)
    if p.returncode:
        out["stderr"] = p.stderr[-2000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    trees = {"earlier": args.earlier.resolve(), "this": ROOT}
    order = []
    while len(order) < 2 * args.pairs:
        order += ["earlier", "this", "this", "earlier"]
    results = []
    for tag in order[:2 * args.pairs]:
        r = dict(tag=tag, **run(trees[tag], args.steps))
        results.append(r)
        print(json.dumps(r), flush=True)
        if r["rc"]:
            return 1
    med = {t: statistics.median(r["median"] for r in results if r["tag"] == t)
           for t in trees}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"median of the runs' median steps: earlier {med['earlier']:.4f} s, "
          f"this {med['this']:.4f} s; {card}")
    out = ROOT / "build" / "train_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=card, runs=results, medians=med),
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
