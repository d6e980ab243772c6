"""Dry run of every cell on one H100: does it fit, and what bounds it?

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out build/dryrun

The twin of ``repro.launch.dryrun``. The reference lowers and compiles
each cell for a TPU mesh and reads XLA's ``memory_analysis`` and
``cost_analysis``. Eager PyTorch has no compiled program, so each cell is
built on the meta device (``launch.steps.build_cell``: nothing allocated,
no weight drawn) and its step is run once there under
:class:`~repro_torch.roofline.count.OpCounter`, which counts the FLOPs and
bytes of every executed op and the peak of live storage;
``roofline.analyze_counted`` turns the counts into the reference's record
for one card (``mesh`` ``"card"``). Nothing runs on a GPU, so any host
can do it.

The reference's ``launch/cost_correct.py`` has no twin, by design: it
exists because XLA's cost analysis counts a while-loop body once, and
extrapolates scanned layers and supersteps from unrolled variants. Here
every op is counted each time it runs, every layer and every superstep on
every trip, so the counts need no correction (``tests/
test_torch_dryrun.py`` holds them to that extrapolation's identity).

A survey cell traced on meta folds every lane of every batch
(``TriangleBatch.valid_index``): the reference's static fold width, so
its FLOPs, bytes and peak are upper bounds of a run on real data.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.launch.steps import all_cells, build_cell
from repro_torch.roofline.analysis import analyze_counted
from repro_torch.roofline.count import OpCounter


def trace_cell(plan) -> dict:
    """Run ``plan.fn(*plan.args)`` once under the op counter; its counts
    (``OpCounter.result``). RoPE's frequencies are cached per device
    (``models.layers._rope_freqs_on``); the cache is emptied first, so
    that every trace counts their copy, whatever ran before it."""
    from repro_torch.models import layers

    layers._rope_freqs_on.cache_clear()
    with OpCounter(plan.args) as counter:
        out = plan.fn(*plan.args)
        counts = counter.result(out)
    return counts


def run_cell(arch: str, shape: str, overrides: dict | None = None) -> dict:
    """Build ``arch`` × ``shape`` on meta, trace it and return the
    reference's record: its analysis keys, ``note``,
    ``model_flops_total``, ``skipped``, ``ok`` and, on failure, ``error``
    and ``traceback``."""
    rec = dict(arch=arch, shape=shape, mesh="card", n_devices=1)
    if overrides:
        rec["overrides"] = overrides
    t0 = time.time()
    try:
        plan = build_cell(arch, shape, overrides=overrides)
        rec["note"] = plan.note
        rec["model_flops_total"] = plan.model_flops
        if plan.skip_reason:
            rec["skipped"] = plan.skip_reason
        rec["build_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        counts = trace_cell(plan)
        rec["trace_s"] = round(time.time() - t1, 2)
        rec.update(analyze_counted(counts, plan.model_flops))
        rec["counts"] = dict(n_ops=counts["n_ops"],
                             bytes_read=counts["bytes_read"],
                             bytes_written=counts["bytes_written"],
                             top_ops=counts["top_ops"])
        rec["ok"] = True
        print(f"[OK] {arch} × {shape} × card: "
              f"fits={rec['fits_hbm']} "
              f"peak={rec['peak_device_bytes']/1e9:.2f}GB "
              f"dominant={rec['dominant']} "
              f"terms={ {k: f'{v:.3e}' for k, v in rec['terms'].items()} } "
              f"(build {rec['build_s']}s trace {rec['trace_s']}s, "
              f"{counts['n_ops']} ops)", flush=True)
        print(f"     memory: {rec['memory']}")
        print(f"     counts: flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e}", flush=True)
    except Exception as e:
        rec["ok"] = False
        rec["error"] = " ".join([f"{type(e).__name__}: {e}"]
                                + getattr(e, "__notes__", []))
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[FAIL] {arch} × {shape} × card: {rec['error']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    n_ok = n_fail = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__card"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        rec = run_cell(arch, shape)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        n_ok += rec["ok"]
        n_fail += not rec["ok"]
    print(f"\ndry-run summary: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
