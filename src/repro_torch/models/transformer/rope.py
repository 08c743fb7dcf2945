"""Rotary position embeddings (RoPE): the angles in float32, the head
split into halves (not interleaved)."""
from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, dh); positions (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
