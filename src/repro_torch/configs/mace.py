"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max 2,
correlation order 3 (E(3)-ACE higher-order message passing)."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="mace", family="mace", n_layers=2, d_hidden=128,
    l_max=2, correlation_order=3, n_rbf=8, cutoff=5.0,
)
SMOKE = CONFIG.scaled(d_hidden=8)
FAMILY = "gnn"
