"""Bidirectional BFS baseline (paper Table 7, "B-BFS").

No index at all: each round expands the smaller of the forward frontier
from u and the backward frontier from v; a lane is answered when the two
visited sets meet.  Batched as Q lanes of (n_cap, Q) planes and relaxed
by the same step as DBL's pruned BFS (``query.relax``), so the comparison
with DBL isolates exactly the value of the labels.

The direction is chosen on the host from one read a round: forward when
the forward frontier holds no more set bits than the backward one, summed
over every lane, answered lanes included (a tie goes forward).  The loop
runs while some lane is unanswered with both frontiers non-empty, and at
most ``max_iters`` rounds.  The reference makes the same choice on the
device, so a lane cut off at ``max_iters`` answers the same in both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, edge_mask
from repro_torch.core.query import relax, relax_edges


def bbfs_chunk(g: Graph, u: torch.Tensor, v: torch.Tensor, *, n_cap: int,
               max_iters: int = 256) -> torch.Tensor:
    """(Q,) bool: does u[q] reach v[q], for a chunk of lanes on the
    graph's device."""
    dev = g.device
    u = u.to(dev).long()
    v = v.to(dev).long()
    live = edge_mask(g)
    fwd_edges = relax_edges(g.src, g.dst, live, n_cap)
    bwd_edges = relax_edges(g.dst, g.src, live, n_cap)
    ids = torch.arange(n_cap, device=dev)
    f_seen = ids[:, None] == u[None, :]    # forward-visited (n_cap, Q)
    b_seen = ids[:, None] == v[None, :]    # backward-visited
    f_fr, b_fr = f_seen, b_seen
    hit = u == v
    it = 0
    while it < max_iters:
        state = torch.stack((
            (f_fr.any(0) & b_fr.any(0) & ~hit).any().long(),
            f_fr.sum(), b_fr.sum())).tolist()
        alive, f_count, b_count = state
        if not alive:
            break
        if f_count <= b_count:
            f_fr = relax(f_fr, *fwd_edges, n_cap=n_cap) & ~f_seen \
                & ~hit[None, :]
            f_seen = f_seen | f_fr
        else:
            b_fr = relax(b_fr, *bwd_edges, n_cap=n_cap) & ~b_seen \
                & ~hit[None, :]
            b_seen = b_seen | b_fr
        hit = hit | (f_seen & b_seen).any(0)
        it += 1
    return hit


def query(g: Graph, u, v, *, n_cap: int, chunk: int = 64,
          max_iters: int = 256) -> np.ndarray:
    """(Q,) np.bool_ answers, ``chunk`` lanes at a time; the last chunk is
    padded with vertex 0."""
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    out = np.zeros(u.shape[0], bool)
    for lo in range(0, u.size, chunk):
        uu = np.pad(u[lo:lo + chunk], (0, max(0, chunk - (u.size - lo))))
        vv = np.pad(v[lo:lo + chunk], (0, max(0, chunk - (v.size - lo))))
        hit = bbfs_chunk(g, torch.from_numpy(uu), torch.from_numpy(vv),
                         n_cap=n_cap, max_iters=max_iters).cpu().numpy()
        out[lo:lo + chunk] = hit[:min(chunk, u.size - lo)]
    return out
