"""The plain reference of the interval planes ("il", GRAIL's random
interval labels), by their definition, in plain torch; imports nothing of
the program.

Each vertex w carries a seed row ``[r(w) | -r(w)]`` of ``2 * dim`` int32
ranks (the program's input, as weights would be).  Over the live edges:

- ``il_in[v]`` is the elementwise min of the seed rows of every w that
  reaches v, v included;
- ``il_out[v]`` is the same over every w that v reaches.

Two ways to the same planes: ``by_closure`` from the dense transitive
closure (small graphs, for the tests), and ``by_fixpoint``, a Jacobi loop
of ``scatter_reduce("amin")`` over the edge list until no row changes
(any size, on the card).  Both are exact: a min of int32s.
"""
from __future__ import annotations

import torch

#: the largest graph ``closure`` takes: its (n, n, n) step is dense
CLOSURE_MAX_N = 300


def closure(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) bool: ``[w, v]`` is True where w reaches v (every vertex
    reaches itself) over the edges ``src -> dst``."""
    if n > CLOSURE_MAX_N:
        raise ValueError(f"a dense closure of {n} vertices; at most "
                         f"{CLOSURE_MAX_N}")
    adj = torch.zeros((n, n), dtype=torch.bool, device=src.device)
    adj[src.long(), dst.long()] = True
    reach = torch.eye(n, dtype=torch.bool, device=src.device) | adj
    while True:
        nxt = reach | (reach[:, :, None] & adj[None, :, :]).any(1)
        if torch.equal(nxt, reach):
            return reach
        reach = nxt


def by_closure(src: torch.Tensor, dst: torch.Tensor, seed: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(il_in, il_out) of the seed rows ``seed`` ((n, 2*dim) int32) over
    the edges ``src -> dst``, from the dense closure."""
    reach = closure(src, dst, seed.shape[0])
    top = torch.iinfo(torch.int32).max
    il_in = torch.where(reach[:, :, None], seed[:, None, :], top).amin(0)
    il_out = torch.where(reach[:, :, None], seed[None, :, :], top).amin(1)
    return il_in, il_out


def _min_along(plane: torch.Tensor, frm: torch.Tensor, to: torch.Tensor
               ) -> torch.Tensor:
    """One Jacobi round: every row ``to[e]`` lowered to the min of itself
    and row ``frm[e]`` of ``plane``, all edges reading the old plane."""
    return plane.scatter_reduce(0, to[:, None].expand(-1, plane.shape[1]),
                                plane[frm], "amin", include_self=True)


def _fixpoint(seed, frm, to):
    cur = seed
    while True:
        nxt = _min_along(cur, frm, to)
        if torch.equal(nxt, cur):
            return cur
        cur = nxt


def by_fixpoint(src: torch.Tensor, dst: torch.Tensor, seed: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(il_in, il_out) as :func:`by_closure`, by a Jacobi loop to no
    change: ``il_in`` pushes rows forward along the edges, ``il_out``
    backward.  The rounds are at most the longest shortest path plus one."""
    src, dst = src.long(), dst.long()
    return _fixpoint(seed, src, dst), _fixpoint(seed, dst, src)
