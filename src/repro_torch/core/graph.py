"""Fully-dynamic directed graph with static capacities.

Edges live in fixed-capacity tensors padded beyond ``m``; every consumer
masks with ``edge_mask(g)``.  Vertices are ``0..n-1`` inside a capacity
``n_cap`` that the label planes carry.  Insertions append.  Deletions are
epoch-versioned tombstones in ``del_at`` (``ALIVE`` = never deleted): an
edge slot is live at delete epoch ``D`` iff ``slot < m and del_at > D``.
``compact`` squeezes the tombstones out for a label rebuild.

``n`` is a 0-d int32 tensor on the graph's device (an insert can grow it
without a host sync); ``m`` and ``del_epoch`` are host ints, because every
insert appends a batch whose size the host knows and every delete batch
bumps the epoch by one (``compact`` reads the live count once).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tracing import span

#: ``del_at`` sentinel for never-deleted edges, above any delete epoch.
ALIVE = np.iinfo(np.int32).max
_U32 = 0xFFFFFFFF


@dataclass
class Graph:
    src: torch.Tensor        # (m_cap,) int32, 0 beyond m
    dst: torch.Tensor        # (m_cap,) int32
    n: torch.Tensor          # () int32: current number of vertices
    m: int                   # append high-water mark (incl. tombstones)
    del_at: torch.Tensor     # (m_cap,) int32 delete epoch per slot
    del_epoch: int = 0       # number of delete batches applied

    @property
    def n_cap(self) -> int:
        """-1: the vertex capacity is carried by the label planes' shapes,
        not by the graph."""
        return -1

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


def make_graph(src, dst, n: int, *, n_cap: int | None = None,
               m_cap: int | None = None, device=None) -> Graph:
    """Build a Graph from edge arrays, with optional headroom ``m_cap``.
    ``n_cap`` is accepted and ignored: the label planes carry the vertex
    capacity."""
    del n_cap
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


def deleted_since(g: Graph, d: int) -> torch.Tensor:
    """(m_cap,) bool: slots live at delete epoch ``d`` but tombstoned now,
    the edges a delta label rebuild from epoch ``d`` must account for."""
    return edge_mask(g, d) & ~edge_mask(g)


def live_edge_count(g: Graph) -> torch.Tensor:
    """() int32: number of live (non-tombstoned) edges."""
    return edge_mask(g).sum().to(torch.int32)


def dead_edge_count(g: Graph) -> torch.Tensor:
    """() int32: number of tombstoned slots below the high-water mark."""
    return (g.m - live_edge_count(g)).to(torch.int32)


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
    # each boolean-mask index reads its count from the card
    with span("repro_torch.sync.insert_keep"):
        at = idx[keep]
    with span("repro_torch.sync.insert_keep"):
        src[at] = new_src[keep]
    with span("repro_torch.sync.insert_keep"):
        dst[at] = new_dst[keep]
    n = g.n if new_n is None else torch.clamp(g.n, min=int(new_n))
    if b:
        nmax = torch.maximum(new_src.max(), new_dst.max()) + 1
        n = torch.maximum(n, nmax.to(torch.int32))
    return replace(g, src=src, dst=dst, n=n, m=g.m + b)


def delete_edges(g: Graph, del_src, del_dst) -> Graph:
    """Tombstone every live edge matching a (del_src, del_dst) pair.

    One call is one delete batch: ``del_epoch`` bumps by 1 and every killed
    slot is stamped ``del_at = del_epoch + 1``.  Parallel duplicates of a
    pair all die; a pair with no live match is a no-op (the epoch still
    bumps).  Labels are not touched.  Pairs are matched as 64-bit keys
    ``src * 2**32 + dst`` with ``isin``, the same set as the reference's
    all-pairs comparison without its (m_cap, b) intermediate."""
    with span("repro_torch.sync.delete_input"):
        ds = torch.as_tensor(del_src, dtype=torch.int64, device=g.device)
    with span("repro_torch.sync.delete_input"):
        dd = torch.as_tensor(del_dst, dtype=torch.int64, device=g.device)
    keys = (g.src.to(torch.int64) << 32) | (g.dst.to(torch.int64) & _U32)
    with span("repro_torch.sync.delete_match"):
        hit = torch.isin(keys, (ds << 32) | (dd & _U32))
    hit = hit & edge_mask(g)
    epoch2 = g.del_epoch + 1
    del_at = torch.where(hit, torch.full_like(g.del_at, epoch2), g.del_at)
    return replace(g, del_at=del_at, del_epoch=epoch2)


def compact(g: Graph) -> Graph:
    """Squeeze tombstones out: live edges move to the front in their
    order, ``m`` drops to the live count and the delete clock resets to 0.
    Slots are renumbered, so snapshot bookkeeping keyed on (m, del_epoch)
    must be re-anchored: the serving engine re-binds its lineage."""
    live = edge_mask(g)
    keep = torch.nonzero(live).squeeze(1)
    m = int(keep.numel())
    src = torch.zeros_like(g.src)
    dst = torch.zeros_like(g.dst)
    src[:m] = g.src[keep]
    dst[:m] = g.dst[keep]
    return Graph(src, dst, g.n, m,
                 torch.full_like(g.del_at, ALIVE), 0)


def reverse(g: Graph) -> Graph:
    return replace(g, src=g.dst, dst=g.src)


def to_networkx(g: Graph):
    """A ``networkx.DiGraph`` of the live edges over vertices ``0..n-1``.
    ``networkx`` is imported here, so the rest of the port runs without
    it."""
    import networkx as nx
    out = nx.DiGraph()
    live = edge_mask(g).cpu().numpy()
    out.add_nodes_from(range(int(g.n)))
    out.add_edges_from(zip(g.src.cpu().numpy()[live].tolist(),
                           g.dst.cpu().numpy()[live].tolist()))
    return out
