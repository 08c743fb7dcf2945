"""Packed bitset algebra on int32 words.

Layouts as in the reference: bool planes ``(n, k)`` uint8, packed words
``(n, W)`` with ``W = ceil(k/32)``.  Lane ``j`` goes to word ``j // 32``,
bit ``j % 32``, LSB first.  Words are int32 here with the same bits as the
reference's uint32 (torch's uint32 lacks ``~``, ``>>`` and ``index_put``
on the CPU), so words are compared with ``!= 0`` and never ordered, and
``>>`` (arithmetic on int32) is masked after every shift.  Pad bits of the
last word stay zero.

The word planes have a segment-OR algebra (``sorted_segment_or``,
``scatter_or``) for the packed fixpoint: torch has no OR scatter
reduction, so it is the reference's segmented inclusive scan over
dst-sorted rows, a Hillis–Steele log-step scan of the ``(flag, value)``
monoid, then one scatter of each segment's tail.
"""
from __future__ import annotations

import torch

from repro_torch.tracing import span

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


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def segment_or_flags(vals: torch.Tensor, start: torch.Tensor,
                     tail: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Segment-OR of pre-sorted (E, W) word rows with boundary flags.

    ``start``/``tail`` (E,) bool mark each segment's first and last entry;
    ``seg_ids`` (E,) are non-decreasing, and ids at or beyond
    ``num_segments`` are dropped.  Returns (num_segments, W), zero for
    empty segments.  The scan takes as many steps as the longest run of
    equal ``seg_ids`` needs, which costs one host read."""
    longest = 0
    if seg_ids.numel():
        with span("repro_torch.sync.segment_runs"):
            runs = torch.unique_consecutive(seg_ids, return_counts=True)[1]
        with span("repro_torch.sync.segment_runs"):
            longest = int(runs.max())
    steps = max(longest - 1, 0).bit_length()
    flag, acc = start, vals
    d = 1
    for _ in range(steps):
        # element i takes the combine of element i - d with itself: a set
        # flag on i stops the carry from the previous segment
        prev = acc[:-d]
        acc = torch.cat([acc[:d], torch.where(flag[d:, None], acc[d:],
                                              prev | acc[d:])])
        flag = torch.cat([flag[:d], flag[d:] | flag[:-d]])
        d *= 2
    # each segment's tail writes its row; every other entry goes to a
    # spare row past the end, which is cut off (no host read to select)
    keep = tail & (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments + 1, vals.shape[-1]), dtype=vals.dtype,
                      device=vals.device)
    out[torch.where(keep, seg_ids.long(), num_segments)] = acc
    return out[:num_segments]


def sorted_segment_or(vals: torch.Tensor, seg_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Segment-OR of (E, W) word rows by non-decreasing (E,) segment ids
    (the word-plane twin of a segment-max on bool planes).  Ids at or
    beyond ``num_segments`` are dropped."""
    if vals.shape[0] == 0:
        return torch.zeros((num_segments, vals.shape[-1]), dtype=vals.dtype,
                           device=vals.device)
    edge = seg_ids[1:] != seg_ids[:-1]
    one = torch.ones(1, dtype=torch.bool, device=vals.device)
    start = torch.cat([one, edge])
    tail = torch.cat([edge, one])
    return segment_or_flags(vals, start, tail, seg_ids, num_segments)


def scatter_or(base: torch.Tensor, values: torch.Tensor,
               at: torch.Tensor) -> torch.Tensor:
    """``base`` (n, W) with word rows ``values`` (b, W) ORed in at row ids
    ``at`` (b,); duplicate ids merge, ids at or beyond n are dropped."""
    if values.shape[0] == 0:
        return base
    order = torch.argsort(at)
    return base | sorted_segment_or(values[order], at[order], base.shape[0])


def popcount(words: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Per-row popcount of (..., W) words -> (...,) int32.  ``k`` masks
    the pad bits of the last word first.  Counted in int64, where the
    words' 32 bits are non-negative and nothing overflows."""
    x = words if k is None else words & pad_mask(k, words.device)
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    per_word = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return per_word.sum(-1).to(torch.int32)


def rows_changed(a: torch.Tensor, b: torch.Tensor,
                 k: int | None = None) -> torch.Tensor:
    """(..., n, W) x (..., n, W) -> (..., n) bool: rows whose words
    differ; ``k`` masks pad bits first."""
    if k is not None:
        m = pad_mask(k, a.device)
        a, b = a & m, b & m
    return (a != b).any(-1)


def bit_row(k: int, idx: torch.Tensor) -> torch.Tensor:
    """One-hot packed row(s): (..., W) int32 with bit ``idx`` set."""
    idx = torch.as_tensor(idx)
    words = torch.arange(n_words(k), device=idx.device)
    bit = torch.ones((), dtype=torch.int64, device=idx.device) << (
        idx % WORD)[..., None].to(torch.int64)
    return _to_int32(torch.where(words == (idx // WORD)[..., None], bit,
                                 torch.zeros_like(bit)))
