"""The port's examples: the JAX package's ``examples/`` on the port.

Each module prints the lines its JAX twin prints, with the same graphs,
seeds, caps and surveys, and returns the numbers it printed from
``main(device=None)`` (``None`` = the card; ``"cpu"`` runs the plain
PyTorch path). Run one as ``python -m repro_torch.examples.<name>
[--device cpu]``. The twins' lines, recorded once, are in
:mod:`repro_torch.examples.expected`.
"""
from __future__ import annotations

import argparse

NAMES = ("quickstart", "closure_survey", "label_survey", "multi_survey",
         "hub_survey", "streaming_survey", "triangle_features_gnn", "train_lm")


def cli(main, doc: str):
    """The command line of an example: ``--device`` (default: the card)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the CUDA device)")
    main(device=ap.parse_args().device)
