"""GRAIL-style random interval labels ("il"), the first plug-in family.

Every vertex draws ``dim`` random int32 ranks r_d(v), and each interval end
is a min over a reach set:

    lo_d(v) = min { r_d(w) : w ∈ Reach(v) }        hi_d(v) = max {...}

u ⇒ v implies Reach(v) ⊆ Reach(u), hence [lo_d(v), hi_d(v)] ⊆
[lo_d(u), hi_d(u)] for every d, and the same holds on ancestor sets for
the "in" direction, so any violated containment certifies
non-reachability: an O(dim) negative prune.  Storing hi negated
(``-hi == min(-r)``) makes both ends one MIN fixpoint, so each direction's
plane is one (n_cap, 2*dim) int32 ``[lo | -hi]`` array driven by
``propagate(monoid="min")``, and the verdict is one comparison sweep:

    il_neg(u, v) = any(out[u] > out[v]) | any(in[v] > in[u])

Insertions only lower the mins, so an interval negative from newer planes
holds for every older snapshot (no edge-count gate).  Deletions can raise
them, which a MIN plane cannot follow, so while the labels carry
un-rebuilt deletions the family contributes nothing, and a rebuild
re-draws both planes from the same seed over the live edges, which makes
a delta rebuild equal a full one bit for bit.  The ranks are those of the
reference's ``jax.random.randint`` (``_threefry``), so the same seed gives
the same planes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tracing import span
from . import families as F
from . import graph as G
from . import propagate as P
from ._threefry import randint

#: Ranks are drawn from [-2^30, 2^30) so negation never overflows int32
#: and the int32-max MIN identity is never a real rank.
_RANK_BOUND = 2 ** 30


def dim_of(plane: torch.Tensor) -> int:
    """Interval dimensions per direction of a (n_cap, 2*dim) plane."""
    return plane.shape[-1] // 2


def rank_plane(n_cap: int, dim: int, seed: int, device=None) -> torch.Tensor:
    """(n_cap, 2*dim) int32 Alg-1 seed plane ``[r | -r]`` on ``device``
    (default ``"cuda"``): every interval starts at its own ranks."""
    r = randint(int(seed), (n_cap, dim), -_RANK_BOUND, _RANK_BOUND)
    plane = np.concatenate([r, -r], axis=1)
    return torch.from_numpy(plane).to(resolve_device(device))


def build_il(g: G.Graph, *, n_cap: int, dim: int, seed: int,
             max_iters: int = 256, combine=None
             ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """Alg-1 analogue: two MIN fixpoints over the live edges from the rank
    seeds.  Returns (il_in, il_out, [iters_in, iters_out]); an iteration
    count of ``max_iters + 1`` means that fixpoint was cut off.
    ``combine`` runs them edge-partitioned (``propagate``)."""
    base = rank_plane(n_cap, dim, seed, g.device)
    live = G.edge_mask(g)
    frontier = torch.ones(n_cap, dtype=torch.bool, device=g.device)
    il_in, it0 = P.propagate(base, g.src, g.dst, live, frontier,
                             n_cap=n_cap, monoid="min", max_iters=max_iters,
                             combine=combine)
    il_out, it1 = P.propagate(base, g.src, g.dst, live, frontier,
                              n_cap=n_cap, monoid="min", max_iters=max_iters,
                              reverse=True, combine=combine)
    return il_in, il_out, [it0, it1]


def insert_update_il(g2: G.Graph, il_in: torch.Tensor, il_out: torch.Tensor,
                     new_src: torch.Tensor, new_dst: torch.Tensor, *,
                     n_cap: int, max_iters: int = 256, combine=None
                     ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """Alg-3 analogue; ``g2`` already holds the new edges.  Edge (u, v)
    hands u's ancestor mins to v (``in[v] ← min(in[v], in[u])``) and v's
    reach mins to u (``out[u] ← min(out[u], out[v])``); each fixpoint then
    pushes from the rows the seeding lowered.  The input planes are left
    as they were.  ``combine`` as in :func:`build_il`: ``g2`` then holds
    this process's block of the edges, the planes are whole."""
    live = G.edge_mask(g2)
    new_src = new_src.to(device=g2.device, dtype=torch.int32)
    new_dst = new_dst.to(device=g2.device, dtype=torch.int32)

    def gather(plane, ids):
        return plane[ids.clamp(0, n_cap - 1).long()]

    with span("repro_torch.insert.fixpoint"):
        seeded_in, fr_in = P.seed_scatter_min(il_in, gather(il_in, new_src),
                                              new_dst, n_cap)
        il_in2, it0 = P.propagate(seeded_in, g2.src, g2.dst, live, fr_in,
                                  n_cap=n_cap, monoid="min",
                                  max_iters=max_iters, inplace=True,
                                  combine=combine)
    with span("repro_torch.insert.fixpoint"):
        seeded_out, fr_out = P.seed_scatter_min(
            il_out, gather(il_out, new_dst), new_src, n_cap)
        il_out2, it1 = P.propagate(seeded_out, g2.src, g2.dst, live, fr_out,
                                   n_cap=n_cap, monoid="min",
                                   max_iters=max_iters, reverse=True,
                                   inplace=True, combine=combine)
    return il_in2, il_out2, [it0, it1]


def il_negative(ilo_u, ilo_v, ili_u, ili_v) -> torch.Tensor:
    """(Q,) bool interval containment violation from gathered (Q, 2*dim)
    rows; shared by the verdicts, the kernels' plain versions and the
    admit planes, so every path prunes the same lanes."""
    return (ilo_u > ilo_v).any(-1) | (ili_v > ili_u).any(-1)


F.register(F.LabelFamily(
    name="il", monoid="min", plane_dtype="int32", verdict="negative",
    while_dirty="none", fused_core=False, packable=False,
    plane_width=staticmethod(lambda dim: 2 * dim),
    seed_plane=rank_plane, build=build_il,
    insert_update=insert_update_il,
    # delta repair == full re-derivation from the same seed over the live
    # edges: deletions churn every dimension, and the draw is a function
    # of (seed, n_cap, dim), so delta equals full bit for bit
    rebuild=build_il,
    negative=il_negative))
