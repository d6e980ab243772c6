"""nequip [arXiv:2101.03164; paper]: O(3)-equivariant potential."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="nequip", family="nequip", n_layers=5, d_hidden=32,
    extras=dict(l_max=2, n_rbf=8, cutoff=5.0),
)
SMOKE = GNNConfig(
    name="nequip-smoke", family="nequip", n_layers=2, d_hidden=8,
    extras=dict(l_max=2, n_rbf=4, cutoff=3.0),
)
SHAPES = GNN_SHAPES
KIND = "gnn"
