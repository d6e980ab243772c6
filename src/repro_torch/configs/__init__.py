"""Architecture registry: ``get_arch(<id>)`` over the architectures the
port has so far. Any other id raises the reference's ``KeyError``."""
from __future__ import annotations

import importlib

ARCH_IDS = {
    # GNN family
    "schnet": "schnet",
}


def get_arch(arch_id: str):
    """Returns the config module: CONFIG, SMOKE, SHAPES, KIND."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")


def list_archs():
    return list(ARCH_IDS)
