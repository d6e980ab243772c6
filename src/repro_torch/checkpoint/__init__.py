from repro_torch.checkpoint.manager import (CheckpointManager, load_manifest,
                                            restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "load_manifest"]
