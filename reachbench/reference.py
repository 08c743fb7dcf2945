"""The plain reference: reachability by breadth-first search over an edge
list, in plain torch, imports nothing of the program.

``reach(src, dst, n, u, v)`` answers ``u[i] ->* v[i]`` (every vertex
reaches itself) over the directed edges ``src -> dst``; ``distances``
gives the length of a shortest such path.  Lanes run in
groups of ``LANES``; each group keeps an (n, lanes) visited plane and
expands, a round at a time, only the out-edges of vertices on some lane's
frontier (a CSR by tail), OR-ing their lanes into their heads by a
scatter-max.  A group stops when every lane has found its target or no
frontier is left.
"""
from __future__ import annotations

import torch

LANES = 64
#: out-edges gathered at once in one round (bounds the (E, lanes) block)
EDGE_BLOCK = 1 << 24


def csr(src: torch.Tensor, dst: torch.Tensor, n: int):
    """(row pointers (n + 1,), heads sorted by tail) of the edge list."""
    order = torch.argsort(src.long(), stable=True)
    heads = dst.long()[order]
    counts = torch.bincount(src.long(), minlength=n)
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr, heads


def _out_edges(ptr, heads, tails):
    """(tail of each edge, head of each edge) of the out-edges of
    ``tails``, as blocks of at most ``EDGE_BLOCK`` edges."""
    start = ptr[tails]
    deg = ptr[tails + 1] - start
    ends = torch.cumsum(deg, 0)
    total = int(ends[-1]) if ends.numel() else 0
    lo = 0
    while lo < total:
        hi = min(lo + EDGE_BLOCK, total)
        pos = torch.arange(lo, hi, device=ptr.device)
        owner = torch.searchsorted(ends, pos, right=True)
        first = ends[owner] - deg[owner]
        yield tails[owner], heads[start[owner] + pos - first]
        lo = hi


def reach_group(ptr, heads, n: int, u: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """(L,) int32: the length of a shortest path ``u[i] ->* v[i]`` for one
    group of L lanes, -1 where there is none."""
    lanes = torch.arange(u.numel(), device=u.device)
    u, v = u.long(), v.long()
    seen = torch.zeros((n, u.numel()), dtype=torch.bool, device=u.device)
    seen[u, lanes] = True
    front = seen.clone()
    hit = seen[v, lanes].clone()
    dist = torch.where(hit, 0, -1).to(torch.int32)
    rounds = 0
    while not bool(hit.all()):
        active = torch.nonzero(front.any(1)).squeeze(1)
        if active.numel() == 0:
            break
        nxt = torch.zeros((n, u.numel()), dtype=torch.int8, device=u.device)
        for t, h in _out_edges(ptr, heads, active):
            nxt.index_reduce_(0, h, front[t].to(torch.int8), "amax",
                              include_self=True)
        front = (nxt > 0) & ~seen
        seen |= front
        rounds += 1
        now = seen[v, lanes]
        dist = torch.where(now & ~hit, rounds, dist)
        hit |= now
    return dist


def distances(src: torch.Tensor, dst: torch.Tensor, n: int,
              u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(Q,) int32: the length of a shortest path ``u[i] ->* v[i]`` over the
    edges ``src -> dst`` on ``n`` vertices, -1 where there is none; all
    tensors on one device."""
    ptr, heads = csr(src, dst, n)
    out = [reach_group(ptr, heads, n, u[i:i + LANES], v[i:i + LANES])
           for i in range(0, u.numel(), LANES)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32,
                                                  device=u.device)


def reach(src: torch.Tensor, dst: torch.Tensor, n: int, u: torch.Tensor,
          v: torch.Tensor) -> torch.Tensor:
    """(Q,) bool: ``u[i] ->* v[i]`` (``distances`` >= 0)."""
    return distances(src, dst, n, u, v) >= 0
