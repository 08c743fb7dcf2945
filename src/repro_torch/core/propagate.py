"""Monotone label-propagation fixpoint (Algorithms 1 and 3).

One BFS level is one edge-parallel relaxation: gather the rows of the
frontier's out-edges, combine them into their heads, and the next frontier
is the set of rows that changed (the paper's subsumption pruning).  The
loop ends on an empty frontier or at ``max_iters``.  Each round tests the
frontier on the host, so it costs one device sync; that is what a CUDA
graph could remove later.

Two monoids: ``"or"`` on 0/1 uint8 planes (DL/BL), a segment-max through
``index_reduce_(..., "amax")``, and ``"min"`` on int32 rank planes (the
interval family), ``index_reduce_(..., "amin")``; both exact because OR and
MIN do not depend on order.  Only the edges whose source is on the
frontier take part in a round; the others add the identity.

Two plane representations drive the OR monoid: ``plane_repr="bool"`` the
uint8 planes above, ``"packed"`` the same fixpoint on (n_cap, W) int32
words, 32 lanes a word: pack at entry, one dst-argsort hoisted out of the
loop, per round a gather, ``bitset.sorted_segment_or`` and a word OR,
unpack at exit.  Word equality is lane equality (pad bits stay zero), so
the frontier, the round count and the saturation report equal the bool
path's.  The MIN monoid has no packed form.

Gathers clamp and scatters drop ids outside ``[0, n_cap)``, as the
reference's do.

**Edge-partitioned rounds** (``combine=``, the auto-partitioned scheme of
``core.distributed``): each process relaxes only its block of the edge
arrays against the whole plane, and ``combine`` merges the processes'
planes in place after every round (one ``all_reduce`` under the monoid).
Every process starts a round from the same plane and reads the same
merged plane after it, so the rounds, the frontier and ``iters`` equal the
single-process fixpoint's, cut off at ``max_iters`` or not.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.tracing import span

from . import bitset

Monoid = Literal["or", "min"]
PlaneRepr = Literal["bool", "packed"]

#: How the vertex-sharded fixpoint exchanges boundary rows: ``"dense"``
#: ships every halo slot every round (``planes.halo_propagate``);
#: ``"sparse"`` is the compacted changed-row exchange (``core.halo``),
#: bitwise equal to dense.
HaloMode = Literal["dense", "sparse"]

PLANE_REPRS = ("bool", "packed")
HALO_MODES = ("dense", "sparse")

#: the MIN monoid's identity: an inactive int32 contribution
INT_MAX = 2 ** 31 - 1


def check_plane_repr(plane_repr: str) -> None:
    if plane_repr not in PLANE_REPRS:
        raise ValueError(
            f"plane_repr must be 'bool' or 'packed', got {plane_repr!r}")


def check_halo_mode(halo_mode: str) -> None:
    if halo_mode not in HALO_MODES:
        raise ValueError(
            f"halo_mode must be one of {HALO_MODES}, got {halo_mode!r}")


def segment_or(base: torch.Tensor, rows: torch.Tensor,
               at: torch.Tensor) -> torch.Tensor:
    """OR 0/1 ``rows`` (b, k) into ``base`` (n, k) in place at row ids
    ``at`` (b,), dropping ids outside ``[0, n)``.  Returns ``base``."""
    keep = (at >= 0) & (at < base.shape[0])
    with span("repro_torch.sync.segment_keep"):
        kept = bool(keep.all())
    if not kept:
        with span("repro_torch.sync.segment_keep"):
            at = at[keep]
        with span("repro_torch.sync.segment_keep"):
            rows = rows[keep]
    if at.numel():
        base.index_reduce_(0, at.long(), rows.to(base.dtype), "amax",
                           include_self=True)
    return base


def _any(frontier: torch.Tensor) -> bool:
    """Whether a fixpoint's frontier holds a row: one host read."""
    with span("repro_torch.sync.fixpoint_go"):
        return bool(frontier.any())


def _frontier_edges(on_frontier: torch.Tensor) -> torch.Tensor:
    """The ids of the edges whose tail is on the frontier: a host read
    of their count."""
    with span("repro_torch.sync.fixpoint_edges"):
        return torch.nonzero(on_frontier).squeeze(1)


def _propagate_packed(labels, src, dst, live, frontier, n_cap, max_iters):
    """OR fixpoint on (n_cap, W) int32 word planes; bool planes in and
    out.  The dst-argsort is hoisted out of the loop; each round relaxes
    the frontier's edges, which stay dst-sorted when selected, so the
    scan takes as many steps as that round's longest in-edge run needs."""
    k = labels.shape[-1]
    words = bitset.pack(labels)
    mask = bitset.pad_mask(k, labels.device)
    order = torch.argsort(dst)
    src_s, dst_s, live_s = src[order], dst[order], live[order]
    it = 0
    while it < max_iters and _any(frontier):
        with span("repro_torch.insert.round"):
            eidx = _frontier_edges(frontier[src_s] & live_s)
            ed = dst_s[eidx]
            agg = bitset.sorted_segment_or(words[src_s[eidx]], ed, n_cap)
            new = (words | agg) & mask
            frontier = (new != words).any(-1)
            words = new
        it += 1
    if _any(frontier):
        it = max_iters + 1
    return bitset.unpack(words, k).to(labels.dtype), it


def propagate(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              live: torch.Tensor, frontier: torch.Tensor, *, n_cap: int,
              monoid: str = "or", max_iters: int = 256,
              reverse: bool = False, plane_repr: str = "bool",
              inplace: bool = False, combine=None
              ) -> tuple[torch.Tensor, int]:
    """Run the fixpoint.  Returns (labels, iters).

    ``iters`` is the number of rounds run, except that a loop cut off at
    ``max_iters`` with the frontier still live reports ``max_iters + 1``,
    so that a truncated fixpoint (stale labels) is told apart from one that
    converged in exactly ``max_iters`` rounds.

    labels   : (n_cap, k) uint8 0/1 plane for ``"or"``, int32 for
               ``"min"`` (copied unless ``inplace``; the packed path
               always returns a new plane).
    src, dst : (m_cap,) int32 edge endpoints; ``reverse=True`` pushes dst->src.
    live     : (m_cap,) bool live-edge mask.
    frontier : (n_cap,) bool initial changed set (seeds).
    plane_repr : ``"packed"`` runs the OR fixpoint on int32 words, bitwise
               equal to ``"bool"`` including ``iters``.
    combine  : None, or ``combine(labels, monoid)``, which merges this
               process's plane with the other processes' in place after
               each round (the edge arrays are then this process's block
               of them; see the module docstring).  Runs on
               ``plane_repr="bool"``.
    """
    check_plane_repr(plane_repr)
    if monoid not in ("or", "min"):
        raise ValueError(f"unknown monoid {monoid!r}")
    if plane_repr == "packed" and monoid != "or":
        raise ValueError("plane_repr='packed' supports the OR monoid only")
    if plane_repr == "packed" and combine is not None:
        raise ValueError("combine= merges bool planes; use "
                         "plane_repr='bool'")
    if reverse:
        src, dst = dst, src
    src = src.clamp(0, n_cap - 1).long()
    live = live & (dst >= 0) & (dst < n_cap)
    dst = dst.long()
    frontier = frontier.to(torch.bool)
    if plane_repr == "packed":
        return _propagate_packed(labels, src, dst, live, frontier, n_cap,
                                 max_iters)
    labels = labels if inplace else labels.clone()
    if combine is not None:
        labels = labels.contiguous()          # a collective's buffer
    reduce = "amax" if monoid == "or" else "amin"
    it = 0
    while it < max_iters and _any(frontier):
        with span("repro_torch.insert.round"):
            eidx = _frontier_edges(frontier[src] & live)
            es, ed = src[eidx], dst[eidx]
            if combine is None:
                old = labels[ed]
                labels.index_reduce_(0, ed, labels[es], reduce,
                                     include_self=True)
                changed = torch.zeros(n_cap, dtype=torch.bool,
                                      device=labels.device)
                changed[ed] = (labels[ed] != old).any(-1)
            else:
                # another process's edges may change any row
                old = labels.clone()
                labels.index_reduce_(0, ed, labels[es], reduce,
                                     include_self=True)
                combine(labels, monoid)
                changed = (labels != old).any(-1)
            frontier = changed
        it += 1
    if _any(frontier):
        it = max_iters + 1
    return labels, it


def reach_mask(src: torch.Tensor, dst: torch.Tensor, live: torch.Tensor,
               seeds: torch.Tensor, *, n_cap: int, max_iters: int,
               reverse: bool = False, plane_repr: str = "bool"
               ) -> tuple[torch.Tensor, int]:
    """(n_cap,) bool: the ``live``-edge reachability closure of ``seeds``
    (inclusive), a single-lane OR fixpoint.  Returns (mask, iters).

    The invalidation frontier of the delta rebuild: seeded from the heads
    of tombstoned edges (tails with ``reverse=True``) and propagated over
    the edge set the labels were built against.  With ``max_iters >=
    n_cap`` the closure always converges.  ``plane_repr="packed"`` runs
    the fixpoint on one word a vertex, bitwise equal."""
    plane = seeds[:, None].to(torch.uint8)
    out, iters = propagate(plane, src, dst, live, seeds, n_cap=n_cap,
                           max_iters=max_iters, reverse=reverse,
                           plane_repr=plane_repr, inplace=True)
    return out[:, 0].to(torch.bool), iters


def push_boundary(src: torch.Tensor, dst: torch.Tensor, live: torch.Tensor,
                  dirty: torch.Tensor, *, n_cap: int,
                  reverse: bool = False,
                  plane_repr: str = "bool") -> torch.Tensor:
    """(n_cap,) bool: vertices with a live edge into the ``dirty`` set (in
    the propagation direction).  With the dirty set they form the first
    frontier of a delta fixpoint.  ``plane_repr="packed"`` ORs one word a
    edge by source (``bitset.sorted_segment_or``), bitwise equal."""
    check_plane_repr(plane_repr)
    if reverse:
        src, dst = dst, src
    hit = live & dirty[dst.clamp(0, n_cap - 1).long()]
    if plane_repr == "packed":
        order = torch.argsort(src)
        agg = bitset.sorted_segment_or(hit.to(torch.int32)[order, None],
                                       src[order], n_cap)
        return agg[:, 0] != 0
    out = torch.zeros(n_cap, dtype=torch.uint8, device=dirty.device)
    segment_or(out[:, None], hit[:, None], src)
    return out.to(torch.bool)


def seed_scatter_or(base: torch.Tensor, values: torch.Tensor,
                    at: torch.Tensor, n_cap: int, *,
                    plane_repr: str = "bool", inplace: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """OR ``values[i]`` (rows, (b, k)) into ``base`` at vertex ``at[i]``
    (in place when ``inplace``).  Returns (new_base, frontier), the
    frontier marking rows that changed.  ``plane_repr="packed"`` scatters
    word rows (``bitset.scatter_or``), bitwise equal."""
    check_plane_repr(plane_repr)
    at = at.long()
    if plane_repr == "packed":
        k = base.shape[-1]
        base_w = bitset.pack(base)
        new_w = bitset.scatter_or(base_w, bitset.pack(values), at)
        frontier = (new_w != base_w).any(-1)
        new = bitset.unpack(new_w, k).to(base.dtype)
        if inplace:
            new = base.copy_(new)
        return new, frontier
    new = base if inplace else base.clone()
    keep = (at >= 0) & (at < n_cap)
    with span("repro_torch.sync.seed_keep"):
        at_k = at[keep]
    old = new[at_k]
    segment_or(new, values, at)
    frontier = torch.zeros(n_cap, dtype=torch.bool, device=base.device)
    frontier[at_k] = (new[at_k] != old).any(-1)
    return new, frontier


def seed_scatter_min(base: torch.Tensor, values: torch.Tensor,
                     at: torch.Tensor, n_cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """MIN twin of ``seed_scatter_or`` for int32 interval planes:
    ``base[at[i]] = min(base[at[i]], values[i])`` row-wise, ids outside
    ``[0, n_cap)`` dropped.  Returns (new_base, frontier), the frontier
    marking the rows whose value fell."""
    new = base.clone()
    at = at.long()
    keep = (at >= 0) & (at < n_cap)
    with span("repro_torch.sync.seed_keep"):
        at_k = at[keep]
    if at_k.numel():
        with span("repro_torch.sync.seed_keep"):
            values = values[keep]
        new.index_reduce_(0, at_k, values.to(base.dtype), "amin",
                          include_self=True)
    frontier = torch.zeros(n_cap, dtype=torch.bool, device=base.device)
    frontier[at_k] = (new[at_k] != base[at_k]).any(-1)
    return new, frontier
