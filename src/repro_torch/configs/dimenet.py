"""dimenet [arXiv:2003.03123]: 6 blocks, d_hidden 128, 8 bilinear units,
7 spherical x 6 radial basis functions."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="dimenet", family="dimenet", n_layers=6, n_blocks=6, d_hidden=128,
    n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0,
)
SMOKE = CONFIG.scaled(d_hidden=16, n_blocks=2)
FAMILY = "gnn"
