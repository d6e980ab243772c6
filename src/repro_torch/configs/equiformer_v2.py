"""equiformer-v2 [arXiv:2306.12059]: SO(2)-eSCN graph attention."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="equiformer-v2", family="equiformer_v2", n_layers=12, d_hidden=128,
    extras=dict(l_max=6, m_max=2, n_heads=8, n_rbf=8, cutoff=5.0),
)
SMOKE = GNNConfig(
    name="equiformer-smoke", family="equiformer_v2", n_layers=2, d_hidden=16,
    extras=dict(l_max=3, m_max=2, n_heads=4, n_rbf=4, cutoff=3.0),
)
SHAPES = GNN_SHAPES
KIND = "gnn"
