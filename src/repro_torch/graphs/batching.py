"""Block-diagonal batching of small graphs (the ``molecule`` shape), in
numpy."""
from __future__ import annotations

import numpy as np


def block_diagonal(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """(B, 2, E) per-graph edges -> (2, B*E) batched edges with offsets."""
    b = edge_index.shape[0]
    offsets = (np.arange(b, dtype=np.int64) * n_nodes)[:, None]
    src = (edge_index[:, 0, :] + offsets).reshape(-1)
    dst = (edge_index[:, 1, :] + offsets).reshape(-1)
    return np.stack([src, dst]).astype(np.int32)


def graph_ids(batch: int, n_nodes: int) -> np.ndarray:
    """(B*N,) int32: the graph id of each flattened node, for a per-graph
    readout."""
    return np.repeat(np.arange(batch, dtype=np.int32), n_nodes)
