"""gemma2-27b [arXiv:2408.00118]: 46L d4608 32H GQA(kv=16) d_ff 36864
vocab 256000 — local+global alternating attention (window 4096), attn
softcap 50, final softcap 30, sandwich (pre+post) RMSNorm, GeGLU."""
from .base import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256_000,
    window=4096,
    layer_pattern="local_global",
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    act="gelu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=256, window=8,
                      dtype="float32", seq_parallel=False)
FAMILY = "lm"
