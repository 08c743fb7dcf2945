"""Edge-insertion index maintenance (paper Algorithm 3, batched).

Inserting (u, v): every landmark reaching u now reaches Des(v) and every
landmark reachable from v is now reachable from Anc(u).  For a batch:
append the edges, OR ``plane[u]`` into ``plane[v]`` (segment-OR when
several edges share a head), and run the frontier-pruned fixpoint over the
updated edge set from the rows that changed; the same for the reverse
direction and for BL.  No DAG is consulted, so SCC merges need nothing
special.
"""
from __future__ import annotations

import torch

from repro_torch.tracing import span

from . import graph as G
from .propagate import propagate, seed_scatter_or


def insert_seeds(plane: torch.Tensor, new_src: torch.Tensor,
                 new_dst: torch.Tensor, *, n_cap: int, reverse: bool = False,
                 plane_repr: str = "bool", inplace: bool = False):
    """Alg-3 seeding of one plane: for each inserted edge (u, v) OR
    ``plane[u]`` into ``plane[v]`` (roles swapped for ``reverse``; in place
    when ``inplace``).  Returns (seeded plane, changed-row frontier)."""
    at_src, at_dst = (new_dst, new_src) if reverse else (new_src, new_dst)
    gathered = plane[at_src.clamp(0, n_cap - 1).long()]
    return seed_scatter_or(plane, gathered, at_dst, n_cap,
                           plane_repr=plane_repr, inplace=inplace)


def insert_and_update(g: G.Graph, dl_in, dl_out, bl_in, bl_out,
                      new_src: torch.Tensor, new_dst: torch.Tensor,
                      epoch: int = 0, *, n_cap: int, max_iters: int = 256,
                      plane_repr: str = "bool", inplace: bool = False):
    """Returns (graph', dl_in', dl_out', bl_in', bl_out', iters [4], epoch').

    Each call is one snapshot epoch (``epoch' = epoch + 1``); with
    append-only edges, (epoch, m) names the exact edge set of a snapshot.
    The input planes are updated in place when ``inplace`` (the serving
    engine's ``donate``), else left as they were.  ``plane_repr="packed"``
    runs the seeding and the fixpoints on int32 words (bitwise equal)."""
    g2 = G.insert_edges(g, new_src, new_dst)
    planes, iters = update_inserted(
        g2, (dl_in, dl_out, bl_in, bl_out), new_src, new_dst, n_cap=n_cap,
        max_iters=max_iters, plane_repr=plane_repr, inplace=inplace)
    return (g2, *planes, iters, epoch + 1)


def update_inserted(g2: G.Graph, planes, new_src: torch.Tensor,
                    new_dst: torch.Tensor, *, n_cap: int,
                    max_iters: int = 256, plane_repr: str = "bool",
                    inplace: bool = False, combine=None):
    """The Alg-3 seeding and fixpoint of the four (dl_in, dl_out, bl_in,
    bl_out) planes over ``g2``, which already holds the new edges.
    Returns (planes', iters [4]).  ``combine`` runs the fixpoints
    edge-partitioned (``propagate``): ``g2`` is then this process's block
    of the edges, and the planes are whole."""
    live = G.edge_mask(g2)
    new_src = new_src.to(device=g2.device, dtype=torch.int32)
    new_dst = new_dst.to(device=g2.device, dtype=torch.int32)

    def run(plane, reverse):
        with span("repro_torch.insert.fixpoint"):
            seeded, frontier = insert_seeds(plane, new_src, new_dst,
                                            n_cap=n_cap, reverse=reverse,
                                            plane_repr=plane_repr,
                                            inplace=inplace)
            return propagate(seeded, g2.src, g2.dst, live, frontier,
                             n_cap=n_cap, max_iters=max_iters,
                             reverse=reverse, plane_repr=plane_repr,
                             inplace=True, combine=combine)

    out = [run(p, rev) for p, rev in zip(planes, (False, True, False, True))]
    return [p for p, _ in out], [it for _, it in out]


def insert_update_plugin(family: str, g2: G.Graph, p_in, p_out,
                         new_src: torch.Tensor, new_dst: torch.Tensor, *,
                         n_cap: int, max_iters: int = 256, combine=None):
    """Alg-3 maintenance of one plug-in label family (``core.families``):
    its ``insert_update`` hook.  ``g2`` already holds the new edges (run
    this after ``insert_and_update``).  Returns (p_in', p_out', iters).
    ``combine`` as in :func:`update_inserted`."""
    from . import families as F
    kw = {} if combine is None else dict(combine=combine)
    return F.get(family).insert_update(g2, p_in, p_out, new_src, new_dst,
                                       n_cap=n_cap, max_iters=max_iters, **kw)


def delete_and_mark(g: G.Graph, del_src, del_dst, epoch: int = 0):
    """Returns (graph', epoch').  Tombstones the matching live edges and
    bumps both clocks: the graph's ``del_epoch`` (one delete batch) and the
    snapshot ``epoch``.  Labels are not touched: deletions only shrink
    reachability, so the labels stay a sound over-approximation whose
    positive evidence the query path downgrades until a rebuild."""
    return G.delete_edges(g, del_src, del_dst), epoch + 1


def saturated(iters, max_iters: int) -> bool:
    """True when any plane's fixpoint was cut off at ``max_iters`` without
    converging (reported as ``max_iters + 1``).  Converging in exactly
    ``max_iters`` rounds is not saturation."""
    return any(int(i) > max_iters for i in iters)
