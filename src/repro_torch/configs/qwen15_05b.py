"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d1024 16H GQA(kv=16) d_ff 2816
vocab 151936 — QKV bias, SwiGLU, tied embeddings."""
from .base import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-0.5b",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=2816,
    vocab=151_936,
    qkv_bias=True,
    act="silu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, d_ff=128, vocab=256, dtype="float32",
                      seq_parallel=False)
FAMILY = "lm"
