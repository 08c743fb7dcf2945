"""pna [arXiv:2004.05718]: 4 layers, d_hidden 75, aggregators
mean-max-min-std, scalers id-amp-atten."""
from .base import GNNConfig

CONFIG = GNNConfig(
    name="pna", family="pna", n_layers=4, d_hidden=75,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
)
SMOKE = CONFIG.scaled(d_hidden=16, n_layers=2)
FAMILY = "gnn"
