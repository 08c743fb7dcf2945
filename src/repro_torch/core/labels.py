"""DL / BL label construction (paper Algorithm 1, batched over sources).

All k sources propagate at once as k lanes of a bool plane, the
multi-source form of Alg 1.  Landmarks are self-seeded
(l ∈ DL_in(l) ∩ DL_out(l)), which Theorem 2 needs.
"""
from __future__ import annotations

import torch

from .graph import Graph, edge_mask
from .planes import REPLICATED, PlaneStore, bl_seed_plane, dl_seed_plane
from .propagate import propagate, push_boundary, segment_or
from .select import leaf_hash


def build_dl(g: Graph, landmarks: torch.Tensor, *, n_cap: int, k: int,
             max_iters: int = 256, plane_repr: str = "bool", combine=None
             ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """-> (dl_in, dl_out, [iters_in, iters_out]), planes (n_cap, k) uint8.
    An iteration count of ``max_iters + 1`` means that fixpoint was cut
    off (see ``propagate``).  ``plane_repr="packed"`` runs both fixpoints
    on int32 words (bitwise-equal planes).  ``combine`` runs them
    edge-partitioned: ``g`` holds this process's block of the edges
    (``propagate``'s ``combine``)."""
    live = edge_mask(g)
    seed = dl_seed_plane(landmarks, n_cap=n_cap, k=k)
    frontier = seed.any(-1)
    dl_in, it0 = propagate(seed, g.src, g.dst, live, frontier,
                           n_cap=n_cap, max_iters=max_iters,
                           plane_repr=plane_repr, combine=combine)
    dl_out, it1 = propagate(seed, g.src, g.dst, live, frontier,
                            n_cap=n_cap, max_iters=max_iters, reverse=True,
                            plane_repr=plane_repr, combine=combine)
    return dl_in, dl_out, [it0, it1]


def build_bl(g: Graph, sources: torch.Tensor, sinks: torch.Tensor, *,
             n_cap: int, k_prime: int, max_iters: int = 256,
             plane_repr: str = "bool", combine=None
             ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """-> (bl_in, bl_out, [iters_in, iters_out]) hashed leaf planes
    (n_cap, k') uint8: BL_in(v) holds h(u) for source leaves u reaching v,
    BL_out(v) holds h(u) for sink leaves u reachable from v.  ``combine``
    as in :func:`build_dl`."""
    live = edge_mask(g)
    seed_in = bl_seed_plane(sources, n_cap=n_cap, k_prime=k_prime)
    bl_in, it0 = propagate(seed_in, g.src, g.dst, live, sources,
                           n_cap=n_cap, max_iters=max_iters,
                           plane_repr=plane_repr, combine=combine)
    seed_out = bl_seed_plane(sinks, n_cap=n_cap, k_prime=k_prime)
    bl_out, it1 = propagate(seed_out, g.src, g.dst, live, sinks,
                            n_cap=n_cap, max_iters=max_iters, reverse=True,
                            plane_repr=plane_repr, combine=combine)
    return bl_in, bl_out, [it0, it1]


# --------------------------------------------------- delta-rebuild pieces
def realign_landmarks(dl_in: torch.Tensor, dl_out: torch.Tensor,
                      old_landmarks: torch.Tensor,
                      new_landmarks: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Permute DL columns from the old lane order to the new landmark
    vector's, matching lanes by landmark identity, not rank.  Lanes whose
    landmark is new come back ``fresh`` (k,) bool; their gathered columns
    are garbage the caller resets to seeds.  Returns (dl_in', dl_out',
    fresh)."""
    eq = new_landmarks[:, None] == old_landmarks[None, :]
    # first match, lane 0 when none, as jnp.argmax picks
    j = torch.argmax(eq.to(torch.uint8), dim=1)
    fresh = ~eq.any(dim=1)
    return dl_in[:, j], dl_out[:, j], fresh


def bucket_churn(old_mask: torch.Tensor, new_mask: torch.Tensor, *,
                 k_prime: int) -> torch.Tensor:
    """(k',) bool: BL buckets whose leaf membership changed.  A removed
    leaf cannot be subtracted from a monotone plane, so churned buckets
    are rebuilt from their seeds as fresh columns."""
    ids = torch.arange(old_mask.shape[0], dtype=torch.int32,
                       device=old_mask.device)
    out = torch.zeros(k_prime, dtype=torch.uint8, device=old_mask.device)
    segment_or(out[:, None], (old_mask ^ new_mask)[:, None],
               leaf_hash(ids, k_prime))
    return out.to(torch.bool)


def delta_plane_state(g: Graph, dl_in, dl_out, bl_in, bl_out,
                      old_landmarks, new_landmarks,
                      old_sources, old_sinks, sources, sinks,
                      dirty_fwd, dirty_bwd, *, n_cap: int, k: int,
                      k_prime: int, layout=REPLICATED):
    """The partially reset fused planes a delta fixpoint restarts from,
    one (rows, k + k') plane per direction (DL lanes first, BL buckets
    after).  An entry is reset to its Alg-1 seed iff its row is dirty (in
    the deleted edges' invalidation closure for that direction) or its
    column is fresh (landmark or leaf-bucket churn); every other entry
    keeps its bits, which old paths avoiding every tombstone certify.

    The planes hold the rows of ``layout`` (one rank's block of a
    vertex-sharded index, or all of them); the masks and the (n_cap,)
    dirty vectors are whole, and the outputs cover the planes' rows.

    Returns (x_fwd, x_bwd, fresh_fwd, fresh_bwd, seed_fwd, seed_bwd,
    frontier_fwd, frontier_bwd)."""
    live = edge_mask(g)
    dl_in_a, dl_out_a, dl_fresh = realign_landmarks(
        dl_in, dl_out, old_landmarks, new_landmarks)
    fresh_fwd = torch.cat([dl_fresh, bucket_churn(old_sources, sources,
                                                  k_prime=k_prime)])
    fresh_bwd = torch.cat([dl_fresh, bucket_churn(old_sinks, sinks,
                                                  k_prime=k_prime)])
    old = PlaneStore(dl_in_a, dl_out_a, bl_in, bl_out, new_landmarks,
                     old_sources, old_sinks, layout=layout)
    seeds = PlaneStore.seeds(new_landmarks, sources, sinks, n_cap=n_cap,
                             k=k, k_prime=k_prime, layout=layout)
    rows = old.rows
    x_fwd, x_bwd = old.reset_invalid(seeds, dirty_fwd[rows],
                                     dirty_bwd[rows], fresh_fwd, fresh_bwd)
    frontier_fwd = dirty_fwd | push_boundary(g.src, g.dst, live, dirty_fwd,
                                             n_cap=n_cap)
    frontier_bwd = dirty_bwd | push_boundary(g.src, g.dst, live, dirty_bwd,
                                             n_cap=n_cap, reverse=True)
    return (x_fwd, x_bwd, fresh_fwd, fresh_bwd, seeds.fused(),
            seeds.fused(reverse=True), frontier_fwd[rows],
            frontier_bwd[rows])
