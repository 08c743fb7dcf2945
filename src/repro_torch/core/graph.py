"""Fully-dynamic directed graph with static capacities.

Edges live in fixed-capacity tensors padded beyond ``m``; every consumer
masks with ``edge_mask(g)``.  Vertices are ``0..n-1`` inside a capacity
``n_cap`` that the label planes carry.  Insertions append.  Deletions are
epoch-versioned tombstones in ``del_at`` (``ALIVE`` = never deleted): an
edge slot is live at delete epoch ``D`` iff ``slot < m and del_at > D``.
This slice ports the insert-only surface; ``del_at``/``del_epoch`` are kept
so an index carried over from the reference keeps its tombstones.

``n`` is a 0-d int32 tensor on the graph's device (an insert can grow it
without a host sync); ``m`` and ``del_epoch`` are host ints, because every
insert appends a batch whose size the host knows.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import resolve_device

#: ``del_at`` sentinel for never-deleted edges, above any delete epoch.
ALIVE = np.iinfo(np.int32).max


@dataclass
class Graph:
    src: torch.Tensor        # (m_cap,) int32, 0 beyond m
    dst: torch.Tensor        # (m_cap,) int32
    n: torch.Tensor          # () int32: current number of vertices
    m: int                   # append high-water mark (incl. tombstones)
    del_at: torch.Tensor     # (m_cap,) int32 delete epoch per slot
    del_epoch: int = 0       # number of delete batches applied

    @property
    def m_cap(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        return Graph(self.src.to(device), self.dst.to(device),
                     self.n.to(device), self.m, self.del_at.to(device),
                     self.del_epoch)


def make_graph(src, dst, n: int, *, m_cap: int | None = None,
               device=None) -> Graph:
    """Build a Graph from edge arrays, with optional headroom ``m_cap``."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    m = int(src.shape[0])
    m_cap = int(m_cap or m)
    if m_cap < m:
        raise ValueError(f"m_cap={m_cap} is below the edge count {m}")
    s = np.zeros(m_cap, dtype=np.int32)
    d = np.zeros(m_cap, dtype=np.int32)
    s[:m] = src
    d[:m] = dst
    return Graph(torch.from_numpy(s).to(dev), torch.from_numpy(d).to(dev),
                 torch.tensor(n, dtype=torch.int32, device=dev), m,
                 torch.full((m_cap,), ALIVE, dtype=torch.int32, device=dev))


def edge_mask(g: Graph, at_del_epoch: int | None = None) -> torch.Tensor:
    """(m_cap,) bool: True for edges live at ``at_del_epoch`` (default now)."""
    d = g.del_epoch if at_del_epoch is None else at_del_epoch
    in_prefix = torch.arange(g.m_cap, device=g.device) < g.m
    return in_prefix & (g.del_at > d)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``vals`` into ``num_segments`` bins; ids outside the range are
    dropped, as the reference's segment reductions drop them."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids[keep].long(), vals[keep])


def degrees(g: Graph, n_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_degree, out_degree), each (n_cap,) int32, over live edges."""
    live = edge_mask(g).to(torch.int32)
    out_deg = segment_sum(live, g.src, n_cap)
    in_deg = segment_sum(live, g.dst, n_cap)
    return in_deg, out_deg


def insert_edges(g: Graph, new_src: torch.Tensor, new_dst: torch.Tensor,
                 new_n: int | None = None) -> Graph:
    """Append a batch of edges at slots m..m+b.  Slots beyond ``m_cap`` are
    dropped, as in the reference; callers size ``m_cap`` for their inserts."""
    b = int(new_src.shape[0])
    new_src = new_src.to(device=g.device, dtype=torch.int32)
    new_dst = new_dst.to(device=g.device, dtype=torch.int32)
    idx = g.m + torch.arange(b, device=g.device)
    keep = idx < g.m_cap
    src = g.src.clone()
    dst = g.dst.clone()
    src[idx[keep]] = new_src[keep]
    dst[idx[keep]] = new_dst[keep]
    n = g.n if new_n is None else torch.clamp(g.n, min=int(new_n))
    if b:
        nmax = torch.maximum(new_src.max(), new_dst.max()) + 1
        n = torch.maximum(n, nmax.to(torch.int32))
    return replace(g, src=src, dst=dst, n=n, m=g.m + b)


def reverse(g: Graph) -> Graph:
    return replace(g, src=g.dst, dst=g.src)
