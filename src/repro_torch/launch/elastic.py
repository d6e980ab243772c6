"""Elastic scaling utilities: the twin of ``repro.launch.elastic``.

A checkpoint is mesh-agnostic (logical global arrays), so it restores
wherever the new allocation says. On one card the reference's "new mesh"
and its placements are a device: ``reshard_restore`` is the one call a
scheduler makes after moving a run.
"""
from __future__ import annotations

from repro_torch.checkpoint.manager import load_manifest, restore_pytree


def reshard_restore(path: str, like, device):
    """Restore ``path`` into ``like``'s structure on ``device``; the tree
    and the manifest's ``extra``."""
    return restore_pytree(path, like, device), load_manifest(path)["extra"]


def replan_batch(global_batch: int, old_devices: int, new_devices: int) -> int:
    """Keep the global batch constant across reshapes when divisible, else
    round to the nearest multiple of the new device count (logged by the
    caller; optimizer hyperparameters are batch-size coupled)."""
    if global_batch % new_devices == 0:
        return global_batch
    return max(new_devices, (global_batch // new_devices) * new_devices)
