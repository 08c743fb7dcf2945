"""Assigned input-shape sets, one per architecture family (40 cells total).

LM shapes lower train_step (train_4k), prefill_step (prefill_32k) or
serve_step (decode_32k / long_500k).  long_500k requires sub-quadratic
attention state: it runs only for gemma2-27b (alternating local windows);
the four pure-full-attention LM archs skip it (DESIGN.md §4).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": LMShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str            # "full" | "minibatch" | "batched"
    n_nodes: int
    n_edges: int
    d_feat: int = 128
    batch_nodes: int = 0
    fanout: tuple = ()
    batch_graphs: int = 0


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full", 2_708, 10_556,
                              d_feat=1_433),
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch", 232_965,
                             114_615_892, d_feat=602, batch_nodes=1_024,
                             fanout=(15, 10)),
    "ogb_products": GNNShape("ogb_products", "full", 2_449_029, 61_859_140,
                             d_feat=100),
    "molecule": GNNShape("molecule", "batched", 30, 64, d_feat=0,
                         batch_graphs=128),
}


@dataclass(frozen=True)
class RecShape:
    name: str
    kind: str            # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


REC_SHAPES = {
    "train_batch": RecShape("train_batch", "train", 65_536),
    "serve_p99": RecShape("serve_p99", "serve", 512),
    "serve_bulk": RecShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": RecShape("retrieval_cand", "retrieval", 1,
                               n_candidates=1_000_000),
}

# (arch family -> shape table) used by the dry-run driver
FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": REC_SHAPES}

# long_500k applicability (DESIGN.md §4): hybrid local/global only.
LONG_CONTEXT_OK = {"gemma2-27b"}
