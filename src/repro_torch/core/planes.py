"""Alg-1 seed planes (the replicated part of the reference's ``planes``)."""
from __future__ import annotations

import torch

from .select import leaf_hash


def dl_seed_plane(landmarks: torch.Tensor, *, n_cap: int, k: int
                  ) -> torch.Tensor:
    """(n_cap, k) uint8 DL seeds: lane l self-seeded at landmark l.
    Landmark ids outside ``[0, n_cap)`` are dropped."""
    seed = torch.zeros((n_cap, k), dtype=torch.uint8, device=landmarks.device)
    lanes = torch.arange(k, device=landmarks.device)
    keep = (landmarks >= 0) & (landmarks < n_cap)
    seed[landmarks[keep].long(), lanes[keep]] = 1
    return seed


def bl_seed_plane(mask: torch.Tensor, *, n_cap: int, k_prime: int
                  ) -> torch.Tensor:
    """(n_cap, k') uint8 BL seeds: leaf ``mask`` hashed to buckets."""
    ids = torch.arange(n_cap, dtype=torch.int32, device=mask.device)
    h = leaf_hash(ids, k_prime)
    onehot = torch.arange(k_prime, device=mask.device)[None, :] == h[:, None]
    return (onehot & mask[:, None]).to(torch.uint8)
