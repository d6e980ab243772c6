"""bst [arXiv:1905.06874; paper]: Behavior Sequence Transformer (Alibaba).

The reference's ``CONFIG``, ``SMOKE``, ``SHAPES`` and ``KIND``, field for
field."""
from repro_torch.configs.base import RECSYS_SHAPES, RecSysConfig

CONFIG = RecSysConfig(
    name="bst", embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    mlp_dims=(1024, 512, 256), n_items=20_000_000, n_sparse_fields=8,
    vocab_per_field=1_000_000,
)
SMOKE = RecSysConfig(
    name="bst-smoke", embed_dim=32, seq_len=8, n_blocks=1, n_heads=4,
    mlp_dims=(64, 32), n_items=5000, n_sparse_fields=3, vocab_per_field=1000,
    dtype="float32",
)
SHAPES = RECSYS_SHAPES
KIND = "recsys"
