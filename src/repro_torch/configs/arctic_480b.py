"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d7168 56H GQA(kv=8)
vocab 32000 — MoE 128 experts top-2 (per-expert d_ff 4864) with a parallel
dense-residual FFN branch (dense-MoE hybrid)."""
from .base import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab=32_000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, dense_residual=True,
                  dense_d_ff=4864),
    act="silu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=64, vocab=256, dtype="float32",
                      seq_parallel=False,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff=64,
                                    dense_residual=True, dense_d_ff=64,
                                    capacity_factor=8.0))
FAMILY = "lm"
