#!/usr/bin/env python3
"""Record the JAX package's example lines for the port's examples.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/record_example_lines.py

Runs each script of ``examples/`` (the JAX package's) in this process,
captures what it prints, and writes ``src/repro_torch/examples/expected.py``,
the yardstick the port's examples are held to on the CPU and on the card
(where there is no JAX). For ``triangle_features_gnn`` and ``train_lm`` it
also records the loss of every training step (a ``jax.debug.callback`` on
the train step, which it wraps without changing its arithmetic);
``train_lm`` parses the command line, so it runs with only a temporary
``--ckpt-dir``. Every run is deterministic; the eight take a few minutes
on a laptop-class CPU.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import pprint
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "closure_survey", "label_survey", "multi_survey",
         "hub_survey", "streaming_survey", "triangle_features_gnn", "train_lm")
OUT = ROOT / "src" / "repro_torch" / "examples" / "expected.py"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_step_losses(mod, traces: list):
    """Wrap the example's ``make_train_step`` so that each training run
    appends its per-step losses to ``traces``."""
    import jax

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


def main() -> int:
    lines, traces, lm_traces = {}, [], []
    for name in NAMES:
        mod = _load(name)
        argv = sys.argv
        if name == "triangle_features_gnn":
            _with_step_losses(mod, traces)
        if name == "train_lm":
            from repro.launch import train as train_driver

            _with_step_losses(train_driver, lm_traces)
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
            sys.argv = [f"{name}.py", "--ckpt-dir", tmp]
            try:
                mod.main()
            finally:
                sys.argv = argv
        lines[name] = buf.getvalue()
        print(f"{name}: {len(lines[name].splitlines())} lines", file=sys.stderr)
    text = OUT.read_text()
    head = text[:text.index("# --- recorded")]
    OUT.write_text(
        head + "# --- recorded by tools/record_example_lines.py; do not edit ---\n"
        f"LINES = {pprint.pformat(lines, width=100)}\n\n"
        f"GNN_STEP_LOSSES = {pprint.pformat(traces, width=100, compact=True)}\n\n"
        "TRAIN_LM_STEP_LOSSES = "
        f"{pprint.pformat(lm_traces[0], width=100, compact=True)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
