"""Monotone label-propagation fixpoint (Algorithms 1 and 3), OR monoid on
bool planes.

One BFS level is one edge-parallel relaxation: gather the rows of the
frontier's out-edges, OR them into their heads, and the next frontier is
the set of rows that changed (the paper's subsumption pruning).  The loop
ends on an empty frontier or at ``max_iters``.  Each round tests the
frontier on the host, so it costs one device sync; that is what a CUDA
graph could remove later.

Segment-OR of 0/1 rows is a segment-max: ``index_reduce_(..., "amax")`` on
uint8, exact because OR does not depend on order.  Only the edges whose
source is on the frontier take part in a round; the others add nothing.
Gathers clamp and scatters drop ids outside ``[0, n_cap)``, as the
reference's do.
"""
from __future__ import annotations

import torch


def segment_or(base: torch.Tensor, rows: torch.Tensor,
               at: torch.Tensor) -> torch.Tensor:
    """OR 0/1 ``rows`` (b, k) into ``base`` (n, k) in place at row ids
    ``at`` (b,), dropping ids outside ``[0, n)``.  Returns ``base``."""
    keep = (at >= 0) & (at < base.shape[0])
    if not bool(keep.all()):
        at, rows = at[keep], rows[keep]
    if at.numel():
        base.index_reduce_(0, at.long(), rows.to(base.dtype), "amax",
                           include_self=True)
    return base


def propagate(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              live: torch.Tensor, frontier: torch.Tensor, *, n_cap: int,
              max_iters: int = 256, reverse: bool = False,
              inplace: bool = False) -> tuple[torch.Tensor, int]:
    """Run the OR fixpoint.  Returns (labels, iters).

    ``iters`` is the number of rounds run, except that a loop cut off at
    ``max_iters`` with the frontier still live reports ``max_iters + 1``,
    so that a truncated fixpoint (stale labels) is told apart from one that
    converged in exactly ``max_iters`` rounds.

    labels   : (n_cap, k) uint8 0/1 plane (copied unless ``inplace``).
    src, dst : (m_cap,) int32 edge endpoints; ``reverse=True`` pushes dst->src.
    live     : (m_cap,) bool live-edge mask.
    frontier : (n_cap,) bool initial changed set (seeds).
    """
    if reverse:
        src, dst = dst, src
    labels = labels if inplace else labels.clone()
    src = src.clamp(0, n_cap - 1).long()
    live = live & (dst >= 0) & (dst < n_cap)
    dst = dst.long()
    frontier = frontier.to(torch.bool)
    it = 0
    while it < max_iters and bool(frontier.any()):
        eidx = torch.nonzero(frontier[src] & live).squeeze(1)
        es, ed = src[eidx], dst[eidx]
        old = labels[ed]
        labels.index_reduce_(0, ed, labels[es], "amax", include_self=True)
        changed = torch.zeros(n_cap, dtype=torch.bool, device=labels.device)
        changed[ed] = (labels[ed] != old).any(-1)
        frontier = changed
        it += 1
    if bool(frontier.any()):
        it = max_iters + 1
    return labels, it


def reach_mask(src: torch.Tensor, dst: torch.Tensor, live: torch.Tensor,
               seeds: torch.Tensor, *, n_cap: int, max_iters: int,
               reverse: bool = False) -> tuple[torch.Tensor, int]:
    """(n_cap,) bool: the ``live``-edge reachability closure of ``seeds``
    (inclusive), a single-lane OR fixpoint.  Returns (mask, iters).

    The invalidation frontier of the delta rebuild: seeded from the heads
    of tombstoned edges (tails with ``reverse=True``) and propagated over
    the edge set the labels were built against.  With ``max_iters >=
    n_cap`` the closure always converges."""
    plane = seeds[:, None].to(torch.uint8)
    out, iters = propagate(plane, src, dst, live, seeds, n_cap=n_cap,
                           max_iters=max_iters, reverse=reverse,
                           inplace=True)
    return out[:, 0].to(torch.bool), iters


def push_boundary(src: torch.Tensor, dst: torch.Tensor, live: torch.Tensor,
                  dirty: torch.Tensor, *, n_cap: int,
                  reverse: bool = False) -> torch.Tensor:
    """(n_cap,) bool: vertices with a live edge into the ``dirty`` set (in
    the propagation direction).  With the dirty set they form the first
    frontier of a delta fixpoint."""
    if reverse:
        src, dst = dst, src
    hit = live & dirty[dst.clamp(0, n_cap - 1).long()]
    out = torch.zeros(n_cap, dtype=torch.uint8, device=dirty.device)
    segment_or(out[:, None], hit[:, None], src)
    return out.to(torch.bool)


def seed_scatter_or(base: torch.Tensor, values: torch.Tensor,
                    at: torch.Tensor, n_cap: int, *, inplace: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """OR ``values[i]`` (rows, (b, k)) into ``base`` at vertex ``at[i]``
    (in place when ``inplace``).  Returns (new_base, frontier), the
    frontier marking rows that changed."""
    new = base if inplace else base.clone()
    at = at.long()
    keep = (at >= 0) & (at < n_cap)
    at_k = at[keep]
    old = new[at_k]
    segment_or(new, values, at)
    frontier = torch.zeros(n_cap, dtype=torch.bool, device=base.device)
    frontier[at_k] = (new[at_k] != old).any(-1)
    return new, frontier
