# Synthetic, seeded, restart-reproducible data pipelines: the twins of
# repro.data's, drawn from the JAX package's keys by models/threefry.py.
from repro_torch.data.recsys import recsys_batch
from repro_torch.data.tokens import lm_batch

__all__ = ["lm_batch", "recsys_batch"]
