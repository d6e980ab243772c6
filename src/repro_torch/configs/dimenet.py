"""dimenet [arXiv:2003.03123]: directional message passing (triplets)."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="dimenet", family="dimenet", n_layers=6, d_hidden=128,
    extras=dict(n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0),
)
SMOKE = GNNConfig(
    name="dimenet-smoke", family="dimenet", n_layers=2, d_hidden=32,
    extras=dict(n_bilinear=4, n_spherical=4, n_radial=4, cutoff=3.0),
)
SHAPES = GNN_SHAPES
KIND = "gnn"
