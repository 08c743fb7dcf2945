"""Landmark and leaf selection (paper §4.1, §6.2, Table 3).

Landmark centrality proxies: ``max``/``min``/``sum`` of |Pre| and |Suc|,
the sampled-betweenness proxy, and the paper's default ``product``.
Leaves: with ``leaf_r == 0`` zero in-degree vertices seed BL_in and zero
out-degree vertices seed BL_out; ``leaf_r > 0`` uses M(u) <= r for both.
"""
from __future__ import annotations

import torch

from .graph import Graph, degrees

_HASH_MULT = 2654435761  # Knuth multiplicative hash
_U32 = 0xFFFFFFFF


def leaf_hash(v: torch.Tensor, k_prime: int) -> torch.Tensor:
    """Hash vertex ids to BL buckets [0, k').  The reference multiplies in
    uint32 and lets it wrap; int64 with a 32-bit mask gives the same bits."""
    h = ((v.to(torch.int64) & _U32) * _HASH_MULT) & _U32
    return ((h >> 5) % k_prime).to(torch.int32)


def centrality(g: Graph, n_cap: int, method: str = "product") -> torch.Tensor:
    """(n_cap,) float32 score; invalid vertices get -1.  float32 as in the
    reference, so that equal scores stay equal and ties keep their order."""
    in_deg, out_deg = degrees(g, n_cap)
    i = in_deg.to(torch.float32)
    o = out_deg.to(torch.float32)
    if method == "max":
        score = torch.maximum(i, o)
    elif method == "min":
        score = torch.minimum(i, o)
    elif method == "sum":
        score = i + o
    elif method == "product":
        score = i * o
    elif method == "betweenness":
        score = torch.sqrt(i * o) * (i + o)
    else:
        raise ValueError(method)
    valid = torch.arange(n_cap, device=score.device) < g.n
    return torch.where(valid, score, torch.full_like(score, -1.0))


def select_landmarks(g: Graph, *, n_cap: int, k: int,
                     method: str = "product") -> torch.Tensor:
    """Top-k vertices by centrality -> (k,) int32 landmark ids.  A stable
    descending sort puts the lower id first on ties, as ``lax.top_k`` does;
    ``torch.topk`` promises no order, and the order fixes the DL lanes.
    ``k > n_cap`` raises ``ValueError``, as ``lax.top_k`` does."""
    if k > n_cap:
        raise ValueError(f"k argument to top_k must be no larger than size "
                         f"along axis; got k={k} with shape=[{n_cap}] and "
                         "axis=0")
    score = centrality(g, n_cap, method)
    order = torch.sort(score, descending=True, stable=True).indices
    return order[:k].to(torch.int32)


def leaf_masks(g: Graph, *, n_cap: int, leaf_r: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sources, sinks) (n_cap,) bool masks seeding BL_in / BL_out."""
    in_deg, out_deg = degrees(g, n_cap)
    valid = torch.arange(n_cap, device=in_deg.device) < g.n
    if leaf_r == 0:
        return valid & (in_deg == 0), valid & (out_deg == 0)
    m = (in_deg * out_deg) <= leaf_r
    return valid & m, valid & m
