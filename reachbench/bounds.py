"""The table of peaks and the bytes and operations each kernel of the
program needs for one launch, from its operands' shapes.

A launch's bound is the larger of its bytes over the card's memory
bandwidth and its integer operations over the card's 32-bit integer
rate.  NVIDIA's published H100 SXM figures: HBM3 at 3.35 TB/s (data
sheet); 64 INT32 lanes per SM (H100 architecture whitepaper, SM table) x
132 SMs x 1.98 GHz, the boost clock behind the data sheet's 67 TFLOP/s of
float32.  One operation is one integer instruction per lane; a 3-input
logic op (LOP3) counts once.  The same arithmetic as the port's
``chip_smoke.py`` (``kernel_timings``), frozen here.

Planes are (n_cap, W) int32 words (W = k/32 for DL, k'/32 for BL); query
ids and cutoffs int32.  Each input byte is counted once and each output
byte once, as these inputs need them.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 132 * 64 * 1.98e9


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S)


def verdicts(n_cap: int, wd: int, wb: int, q: int, ncut: int,
             out_bytes: int = 1) -> tuple[int, int]:
    """(bytes, operations) of one grid verdict launch over Q lanes.

    Each distinct vertex's four label rows are read once, whether it is a
    u, a v or both; the lanes are uniform, so the distinct vertices are
    taken as ``min(2Q, n_cap)`` (which counts a repeated id twice: at most
    a few in a thousand on these graphs).  Per lane: u, v, each freshness
    row, and the verdict written.  Operations per lane: one logic op a
    word for Lemma 1 and each of the three theorem intersections (4 Wd),
    one a word for each BL containment test (2 Wb), and the gates and the
    select (8)."""
    rows = min(2 * q, n_cap)
    nbytes = rows * (2 * wd + 2 * wb) * 4 + q * (4 + 4 + 4 * ncut
                                                 + out_bytes)
    ops = q * (4 * wd + 2 * wb + 8)
    return nbytes, ops


def admit(n_cap: int, wd: int, wb: int, q: int, fresh: bool
          ) -> tuple[int, int]:
    """(bytes, operations) of one admit-plane launch over Qc lanes.

    The three vertex planes it tests (BL in, BL out, DL in) read once;
    per lane its ids, its freshness row and three query-side rows; the
    (n_cap, Qc) int8 plane written.  Operations per output byte: one logic
    op a word for each BL containment test and for the DL intersection,
    then the combine and the store's select."""
    per_vertex = (2 * wb + wd) * 4
    nbytes = n_cap * per_vertex + q * (per_vertex + 8 + 4 * fresh) \
        + n_cap * q
    ops = n_cap * q * (2 * wb + wd + 2)
    return nbytes, ops
