"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d2048 16H
GQA(kv=16) vocab 163840 — MoE 64 experts top-6, per-expert d_ff 1408,
plus shared experts (moonlight keeps 2 always-on)."""
from .base import MoEConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,           # per-expert hidden (the dense d_ff is unused)
    vocab=163_840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
    act="silu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    rope_theta=50_000.0,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, d_ff=64, vocab=256, dtype="float32",
                      seq_parallel=False,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff=64,
                                    n_shared=1, capacity_factor=8.0))
FAMILY = "lm"
