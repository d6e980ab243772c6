"""schnet [arXiv:1706.08566; paper]: continuous-filter convolutions."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="schnet", family="schnet", n_layers=3, d_hidden=64,
    extras=dict(n_rbf=300, cutoff=10.0),
)
SMOKE = GNNConfig(
    name="schnet-smoke", family="schnet", n_layers=2, d_hidden=16,
    extras=dict(n_rbf=32, cutoff=3.0),
)
SHAPES = GNN_SHAPES
KIND = "gnn"
