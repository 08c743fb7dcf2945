"""Config dataclasses for every architecture family + the DBL index."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    n_shared: int = 0              # always-on shared experts (moonlight-style)
    dense_residual: bool = False   # parallel dense FFN branch (arctic)
    dense_d_ff: int = 0            # hidden of the dense residual branch
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False          # qwen1.5
    attn_softcap: float | None = None   # gemma2: 50.0
    final_softcap: float | None = None  # gemma2: 30.0
    window: int | None = None       # sliding window for local layers
    layer_pattern: str = "global"   # "global" | "local_global" (alternating)
    post_norm: bool = False         # gemma2 sandwich norms
    moe: MoEConfig | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"               # "silu" (swiglu) | "gelu" (geglu)
    dtype: str = "bfloat16"         # compute dtype
    param_dtype: str = "float32"    # storage dtype (bf16 for >=16B configs)
    optimizer: str = "adamw"        # adafactor for >=16B (state memory)
    ce_chunk: int = 0               # chunked cross-entropy (0 = full logits)
    remat: bool = True
    seq_parallel: bool = True       # shard residual seq -> model axis
    moe_token_shard: str = "dp"     # "dp" | "all": slot-array sharding axes
    moe_impl: str = "pjit"          # "pjit" | "shard_map" (explicit a2a)

    def scaled(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    @property
    def params_dense(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        if self.moe is None:
            ffn = 3 * d * f
        else:
            m = self.moe
            ffn = m.n_experts * 3 * d * m.d_ff + m.n_shared * 3 * d * m.d_ff
            if m.dense_residual:
                ffn += 3 * d * (m.dense_d_ff or m.d_ff)
            ffn += d * m.n_experts  # router
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn) + emb

    @property
    def params_active(self) -> int:
        """Active params per token (MoE-aware), for MODEL_FLOPS = 6·N_active·D."""
        if self.moe is None:
            return self.params_dense
        d, L, V = self.d_model, self.n_layers, self.vocab
        m = self.moe
        attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        ffn = (m.top_k + m.n_shared) * 3 * d * m.d_ff
        if m.dense_residual:
            ffn += 3 * d * (m.dense_d_ff or m.d_ff)
        ffn += d * m.n_experts
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn) + emb


@dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str                    # "pna" | "nequip" | "mace" | "dimenet"
    n_layers: int
    d_hidden: int
    d_feat: int = 128              # input node feature dim (overridden per shape)
    n_classes: int = 16
    # PNA
    aggregators: tuple = ("mean", "max", "min", "std")
    scalers: tuple = ("identity", "amplification", "attenuation")
    # equivariant
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    correlation_order: int = 3     # MACE
    # dimenet
    n_blocks: int = 6
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    n_species: int = 16
    dtype: str = "float32"
    msg_dtype: str = "float32"      # "bfloat16" halves collective bytes
    fused_stats: bool = False       # fuse mean/std/count into one scatter
    trip_proj_dim: int = 0          # dimenet: project msg to this dim BEFORE
                                    # the triplet gather (0 = faithful)
    shard_axes: str = "all"         # "all" | "dp": graph-array sharding

    def scaled(self, **kw) -> "GNNConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RecSysConfig:
    name: str
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    n_items: int = 2_000_000
    hist_len: int = 50
    pow_p: float = 2.0             # label-aware attention sharpness
    n_neg: int = 512               # sampled-softmax negatives
    dtype: str = "float32"

    def scaled(self, **kw) -> "RecSysConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DBLConfig:
    name: str = "dbl"
    k: int = 64                    # DL landmark bits
    k_prime: int = 64              # BL hash bits
    selection: str = "product"
    leaf_r: int = 0
    max_iters: int = 256
