"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max 2, 8 radial
Bessel functions, cutoff 5 Å, E(3) tensor-product equivariance."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="nequip", family="nequip", n_layers=5, d_hidden=32,
    l_max=2, n_rbf=8, cutoff=5.0,
)
SMOKE = CONFIG.scaled(d_hidden=8, n_layers=2)
FAMILY = "gnn"
