"""Segment-reduction message passing on tensors.

Message passing is a gather at the edges' sources and a reduction of the
messages into their destinations, over an edge index (2, m).  The GNN
models build on these functions; the DBL fixpoints use the same
gather -> segment-reduce shape on bit planes.

The reductions follow ``jax.ops.segment_*``: ids outside ``[0, n)`` are
dropped (they land in a spare segment that is cut off, so no host sync
is needed), and an empty segment holds the reduction's identity: 0 for a
sum, ``-inf`` for a float max and ``+inf`` for a float min (an integer
type's least and greatest value).  A max or min is exact; a sum, mean,
std or softmax adds in another order than XLA does, so float32 results
may differ from the reference's in the last bits.
"""
from __future__ import annotations

import torch

_IDENTITY = {"sum": 0.0, "amax": float("-inf"), "amin": float("inf")}


def _identity(dtype: torch.dtype, reduce: str):
    if reduce == "sum" or dtype.is_floating_point:
        return _IDENTITY[reduce]
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def segment_reduce(vals: torch.Tensor, ids: torch.Tensor, n: int,
                   reduce: str = "sum") -> torch.Tensor:
    """(n, *vals.shape[1:]): the rows of ``vals`` reduced into ``n``
    segments by ``ids`` (any order), ``reduce`` one of "sum", "amax",
    "amin"."""
    if reduce not in _IDENTITY:
        raise ValueError(f"unknown reduction {reduce!r}")
    ids = ids.long()
    bins = torch.where((ids >= 0) & (ids < n), ids, n)
    out = torch.full((n + 1, *vals.shape[1:]), _identity(vals.dtype, reduce),
                     dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        out.index_add_(0, bins, vals)
    else:
        out.index_reduce_(0, bins, vals, reduce, include_self=True)
    return out[:n]


def gather_src(x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """x (n, d); edge_index (2, m) -> messages at source endpoints (m, d)."""
    return x.index_select(0, edge_index[0].long())


def scatter_sum(msg: torch.Tensor, edge_index: torch.Tensor,
                n: int) -> torch.Tensor:
    return segment_reduce(msg, edge_index[1], n, "sum")


def scatter_mean(msg: torch.Tensor, edge_index: torch.Tensor, n: int,
                 eps: float = 1e-9) -> torch.Tensor:
    s = scatter_sum(msg, edge_index, n)
    cnt = segment_reduce(msg.new_ones(msg.shape[0]), edge_index[1], n)
    return s / (cnt[:, None] + eps)


def scatter_max(msg: torch.Tensor, edge_index: torch.Tensor,
                n: int) -> torch.Tensor:
    return segment_reduce(msg, edge_index[1], n, "amax")


def scatter_min(msg: torch.Tensor, edge_index: torch.Tensor,
                n: int) -> torch.Tensor:
    return segment_reduce(msg, edge_index[1], n, "amin")


def scatter_std(msg: torch.Tensor, edge_index: torch.Tensor, n: int,
                eps: float = 1e-5) -> torch.Tensor:
    mean = scatter_mean(msg, edge_index, n)
    mean2 = scatter_mean(msg * msg, edge_index, n)
    return torch.sqrt(torch.clamp(mean2 - mean * mean, min=0.0) + eps)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Numerically stable softmax over ragged segments (edge scores by
    destination)."""
    ids = segment_ids.long()
    smax = segment_reduce(scores, ids, n, "amax")
    ex = torch.exp(scores - smax[ids])
    ssum = segment_reduce(ex, ids, n)
    return ex / (ssum[ids] + 1e-9)


def degrees_from_edges(edge_index: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32 in-degree per destination node."""
    ones = torch.ones(edge_index.shape[1], dtype=torch.float32,
                      device=edge_index.device)
    return segment_reduce(ones, edge_index[1], n)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int, *, mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` in the reference's form: a ragged gather
    and a segment reduction.  table (V, d); indices (nnz,) row ids;
    bag_ids (nnz,) the output slot of each index, in any order.  An empty
    bag gives 0 for "sum" and "mean" and ``-inf`` for "max"."""
    rows = table.index_select(0, indices.long())
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_reduce(rows, bag_ids, n_bags)
    if mode == "mean":
        s = segment_reduce(rows, bag_ids, n_bags)
        c = segment_reduce(rows.new_ones(indices.shape[0]), bag_ids, n_bags)
        return s / (c[:, None] + 1e-9)
    if mode == "max":
        return segment_reduce(rows, bag_ids, n_bags, "amax")
    raise ValueError(mode)
