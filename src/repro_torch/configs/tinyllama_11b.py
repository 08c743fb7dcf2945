"""tinyllama-1.1b [arXiv:2401.02385]: 22L d2048 32H GQA(kv=4) d_ff 5632
vocab 32000 — llama2 architecture, SwiGLU, untied embeddings."""
from .base import TransformerConfig

CONFIG = TransformerConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32_000,
    act="silu",
    tie_embeddings=False,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
                      d_head=8, d_ff=128, vocab=256, dtype="float32",
                      seq_parallel=False)
FAMILY = "lm"
