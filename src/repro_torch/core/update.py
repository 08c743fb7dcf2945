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
    live = G.edge_mask(g2)
    new_src = new_src.to(device=g2.device, dtype=torch.int32)
    new_dst = new_dst.to(device=g2.device, dtype=torch.int32)

    def run(plane, reverse):
        seeded, frontier = insert_seeds(plane, new_src, new_dst,
                                        n_cap=n_cap, reverse=reverse,
                                        plane_repr=plane_repr,
                                        inplace=inplace)
        return propagate(seeded, g2.src, g2.dst, live, frontier,
                         n_cap=n_cap, max_iters=max_iters, reverse=reverse,
                         plane_repr=plane_repr, inplace=True)

    dl_in2, it0 = run(dl_in, False)
    dl_out2, it1 = run(dl_out, True)
    bl_in2, it2 = run(bl_in, False)
    bl_out2, it3 = run(bl_out, True)
    return g2, dl_in2, dl_out2, bl_in2, bl_out2, [it0, it1, it2, it3], \
        epoch + 1


def insert_update_plugin(family: str, g2: G.Graph, p_in, p_out,
                         new_src: torch.Tensor, new_dst: torch.Tensor, *,
                         n_cap: int, max_iters: int = 256):
    """Alg-3 maintenance of one plug-in label family (``core.families``):
    its ``insert_update`` hook.  ``g2`` already holds the new edges (run
    this after ``insert_and_update``).  Returns (p_in', p_out', iters)."""
    from . import families as F
    return F.get(family).insert_update(g2, p_in, p_out, new_src, new_dst,
                                       n_cap=n_cap, max_iters=max_iters)


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
