"""Packed bitset algebra on int32 words.

Layouts as in the reference: bool planes ``(n, k)`` uint8 for the fixpoint,
packed words ``(n, W)`` with ``W = ceil(k/32)`` for the query path.  Lane
``j`` goes to word ``j // 32``, bit ``j % 32``, LSB first.  Words are int32
here with the same bits as the reference's uint32 (torch's uint32 lacks
``~``, ``>>`` and ``index_put`` on the CPU), so words are compared with
``!= 0`` and never ordered.  Pad bits of the last word stay zero.
"""
from __future__ import annotations

import torch

WORD = 32


def n_words(k: int) -> int:
    return (k + WORD - 1) // WORD


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pad_mask(k: int, device=None) -> torch.Tensor:
    """(W,) int32: ones in the k valid lane bits, zeros in the pad bits."""
    w = n_words(k)
    lanes = torch.arange(w * WORD, device=device).reshape(w, WORD)
    weights = torch.ones((), dtype=torch.int64, device=device) << torch.arange(
        WORD, device=device)
    return _to_int32(((lanes < k).to(torch.int64) * weights).sum(-1))


def pack(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., k) bool/uint8 plane into (..., ceil(k/32)) int32 words."""
    k = bits.shape[-1]
    w = n_words(k)
    pad = w * WORD - k
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(bits.shape[:-1] + (w, WORD))
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD, device=bits.device)
    return _to_int32((b * weights).sum(-1))


def unpack(words: torch.Tensor, k: int) -> torch.Tensor:
    """Unpack (..., W) int32 words into a (..., k) bool plane."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return bits[..., :k] != 0


def intersect_any(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., W) x (..., W) -> (...,) bool: whether a ∩ b ≠ ∅."""
    return ((a & b) != 0).any(-1)


def subset(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., W) x (..., W) -> (...,) bool: whether a ⊆ b."""
    return ((a & ~b) == 0).all(-1)
