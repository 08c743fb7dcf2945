"""mind [arXiv:1904.08030]: embed_dim 64, 4 interest capsules, 3 routing
iterations, multi-interest retrieval. Item vocabulary 2M (shape D.6 regime)."""
from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
    n_items=2_097_152,  # 2^21: evenly 512-way row-shardable
    hist_len=50,
)
SMOKE = CONFIG.scaled(n_items=1_000, hist_len=8, n_neg=16)
FAMILY = "recsys"
