#!/usr/bin/env python3
"""How far the JAX package's GNN example moves under a 1e-6 change of its
initial weights: the reference's own sensitivity, beside the port's gap.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/gnn_chaos_witness.py [--seeds 3]

Runs ``examples/triangle_features_gnn.py`` (the JAX package's) in this
process, once as it is and once per seed with every initial weight moved
by 1e-6 × a standard normal draw (numpy, seeded). The arithmetic of the
example is untouched: only ``schnet.init_params``'s result is shifted.
For each run it prints the final losses and accuracies and, per training
run, the first step (0-based) at which the perturbed run's loss differs
from the unperturbed one by more than ``expected.LOSS_TOL``. It then runs
the port's example on the CPU and prints the same step for the port
against the recorded twin losses (``expected.GNN_STEP_LOSSES``). One JSON
object per line.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import re
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.examples import expected  # noqa: E402


def _twin():
    spec = importlib.util.spec_from_file_location(
        "_twin_triangle_features_gnn",
        ROOT / "examples" / "triangle_features_gnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_twin(seed: int | None, delta: float) -> dict:
    """The twin's main, its weights shifted by ``delta`` × N(0, 1) draws
    from ``seed`` (``None``: unshifted); its per-step losses and the
    final numbers it prints."""
    import jax

    mod = _twin()
    traces = []
    make = mod.make_train_step

    def recording(loss_fn, opt, **kw):
        losses = []
        traces.append(losses)
        step = make(loss_fn, opt, **kw)

        def wrapped(state, batch):
            state, m = step(state, batch)
            jax.debug.callback(lambda x: losses.append(float(x)), m["loss"],
                               ordered=True)
            return state, m
        return wrapped

    mod.make_train_step = recording
    if seed is not None:
        rng = np.random.default_rng(seed)
        real = mod.schnet

        def shifted(key, cfg):
            p = real.init_params(key, cfg)
            return jax.tree.map(lambda w: w + np.asarray(
                delta * rng.standard_normal(w.shape), w.dtype), p)

        mod.schnet = types.SimpleNamespace(Cfg=real.Cfg, forward=real.forward,
                                           init_params=shifted)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    jax.effects_barrier()
    pairs = re.findall(r"loss ([\d.]+), accuracy ([\d.]+)", buf.getvalue())
    return dict(seed=seed, delta=delta if seed is not None else 0.0,
                final=[dict(loss=float(a), accuracy=float(b)) for a, b in pairs],
                losses=traces)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--delta", type=float, default=1e-6)
    a = ap.parse_args()
    base = _run_twin(None, 0.0)
    assert base["losses"] == expected.GNN_STEP_LOSSES, "twin != recorded"
    print(json.dumps(dict(run="twin", final=base["final"])), flush=True)
    for seed in range(a.seeds):
        r = _run_twin(seed, a.delta)
        print(json.dumps(dict(
            run="twin shifted", seed=seed, delta=a.delta, final=r["final"],
            final_loss_moved=[x["loss"] - y["loss"]
                              for x, y in zip(r["final"], base["final"])],
            first_step_past_tol=[expected.first_step_past(x, y)
                                 for x, y in zip(r["losses"], base["losses"])])),
            flush=True)

    import torch

    from repro_torch.examples import triangle_features_gnn as tfg
    torch.set_num_threads(1)
    with contextlib.redirect_stdout(io.StringIO()):
        out = tfg.main(device="cpu")
    print(json.dumps(dict(
        run="port (CPU)", final=[dict(loss=out[r]["loss"],
                                      accuracy=out[r]["accuracy"])
                                 for r in ("base", "tri")],
        first_step_past_tol=expected.first_steps_past(out))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
