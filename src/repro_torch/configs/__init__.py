"""Architecture registry: ``get_arch(<id>)`` over the reference's eleven
architectures. Any other id raises the reference's ``KeyError``."""
from __future__ import annotations

import importlib

ARCH_IDS = {
    # LM family (5)
    "internlm2-1.8b": "internlm2_1_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    # GNN family (4)
    "nequip": "nequip",
    "schnet": "schnet",
    "dimenet": "dimenet",
    "equiformer-v2": "equiformer_v2",
    # recsys (1)
    "bst": "bst",
    # the paper's own workload
    "tripoll": "tripoll",
}


def get_arch(arch_id: str):
    """Returns the config module: CONFIG, SMOKE, SHAPES, KIND (+OPTIMIZER)."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")


def list_archs():
    return list(ARCH_IDS)
