"""DL / BL label construction (paper Algorithm 1, batched over sources).

All k sources propagate at once as k lanes of a bool plane, the
multi-source form of Alg 1.  Landmarks are self-seeded
(l ∈ DL_in(l) ∩ DL_out(l)), which Theorem 2 needs.
"""
from __future__ import annotations

import torch

from .graph import Graph, edge_mask
from .planes import bl_seed_plane, dl_seed_plane
from .propagate import propagate


def build_dl(g: Graph, landmarks: torch.Tensor, *, n_cap: int, k: int,
             max_iters: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """-> (dl_in, dl_out, [iters_in, iters_out]), planes (n_cap, k) uint8.
    An iteration count of ``max_iters + 1`` means that fixpoint was cut
    off (see ``propagate``)."""
    live = edge_mask(g)
    seed = dl_seed_plane(landmarks, n_cap=n_cap, k=k)
    frontier = seed.any(-1)
    dl_in, it0 = propagate(seed, g.src, g.dst, live, frontier,
                           n_cap=n_cap, max_iters=max_iters)
    dl_out, it1 = propagate(seed, g.src, g.dst, live, frontier,
                            n_cap=n_cap, max_iters=max_iters, reverse=True)
    return dl_in, dl_out, [it0, it1]


def build_bl(g: Graph, sources: torch.Tensor, sinks: torch.Tensor, *,
             n_cap: int, k_prime: int, max_iters: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """-> (bl_in, bl_out, [iters_in, iters_out]) hashed leaf planes
    (n_cap, k') uint8: BL_in(v) holds h(u) for source leaves u reaching v,
    BL_out(v) holds h(u) for sink leaves u reachable from v."""
    live = edge_mask(g)
    seed_in = bl_seed_plane(sources, n_cap=n_cap, k_prime=k_prime)
    bl_in, it0 = propagate(seed_in, g.src, g.dst, live, sources,
                           n_cap=n_cap, max_iters=max_iters)
    seed_out = bl_seed_plane(sinks, n_cap=n_cap, k_prime=k_prime)
    bl_out, it1 = propagate(seed_out, g.src, g.dst, live, sinks,
                            n_cap=n_cap, max_iters=max_iters, reverse=True)
    return bl_in, bl_out, [it0, it1]
