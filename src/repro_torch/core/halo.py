"""The sparse halo exchange of the vertex-sharded fixpoint.

The dense exchange (``planes.halo_propagate``) ships every halo slot of
every (sender, receiver) pair every round.  On power-law graphs the
boundary covers most rows, so once the frontier has collapsed to a few
rows a round still pays the full cut.  This module moves only what
changed, and stays bitwise equal to the dense exchange: the rounds relax
the same edges with the same monotone reductions, only the transport of
boundary rows differs.

- **Changed rows only.**  Under OR and MIN a row changes only while it is
  in the frontier, so a boundary row travels in round r iff it is in the
  round-r frontier.  Each pair's changed rows are compacted into a bucket
  of a power-of-two capacity (at most two per plan, :func:`bucket_caps`),
  ``(d, cap)`` int32 positions and a ``(d, cap, kf)`` payload, sent with
  two ``all_to_all_single``; the receiver scatters them into its combined
  table by slot.  A row that does not travel is one the receiver already
  holds.
- **Overflow.**  A round whose largest pair count exceeds the bucket runs
  dense (every rank agrees, so the whole round is promoted, not a pair).
  The result is the same; dense rounds cost dense bytes.
- **The hub lane.**  The plan's top ``hub_count`` cut vertices leave the
  pair buckets in sparse rounds and travel once a round on one
  ``all_reduce(SUM)`` of their rows and flags: the owner adds the row,
  every other rank zeros, so the sum is exact (each row has one owner;
  that holds for negative MIN ranks and for words with the top bit set).
  In dense rounds hubs ride the pair buffers.
- **Quiet rounds.**  A round with no changed boundary row and no active
  hub is local: no payload collective at all.

The regimes (dense, sparse(C), local) are the reference's
(``src/repro/core/halo.py``), where each is a device while-loop whose
condition also asserts that the regime still applies, and the host picks
the next regime when one ends.  Here the loop is on the host, as the
dense fixpoint's is: each round one ``all_reduce(SUM)`` carries this
rank's row of the (d, d) per-pair changed-row counts (hub rows left out),
its frontier count and its active-hub count, and every rank reads the
same matrix with one host read.  From it each rank derives the regime
(keeping the current one while it applies, as the reference's loop
condition does), and the telemetry's quiet and non-quiet pair counts, so
every rank takes the same branch.  :class:`HaloTelemetry` models the
bytes of every round from that activity, for the dense and the sparse
exchange alike, with the reference's formulas.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from . import planes as PL
from .propagate import INT_MAX, check_plane_repr


def bucket_caps(H: int) -> tuple[int, ...]:
    """The sparse bucket capacities for a halo width ``H``: at most two
    powers of two, both below ``H`` so a sparse round is never wider than
    a dense one.  Halos narrower than 16 rows get none."""
    if H < 16:
        return ()
    hi = 1
    while hi * 4 < H:
        hi *= 2                      # the largest power of two <= H/4
    lo = max(8, hi // 8)
    return tuple(sorted({c for c in (lo, hi) if c < H}))


@dataclass
class HaloTelemetry:
    """Halo-exchange accounting over fixpoints, with the reference's byte
    model: a dense round pays every pair's ``H x (row + flag)`` buffer; a
    sparse round ``cap x (row + 4-byte position)`` per non-quiet pair, a
    4-byte count per pair and the hub lane's rows and flags on every
    rank; a local round only the 4-byte liveness count per rank.
    Dense-mode fixpoints are recorded by :meth:`add_dense` and counted in
    at :meth:`sync`."""
    bytes: int = 0
    rounds: int = 0
    dense_rounds: int = 0
    sparse_rounds: int = 0
    local_rounds: int = 0
    quiet_pair_rounds: int = 0
    nonquiet_pair_rounds: int = 0
    fixpoints: int = 0
    _pending: list = field(default_factory=list, repr=False)

    def add_dense(self, iters, bytes_per_round: int,
                  max_iters: int) -> None:
        """Record a dense-mode fixpoint of ``iters`` rounds (``max_iters +
        1`` when truncated, which counts ``max_iters``)."""
        self._pending.append((iters, int(bytes_per_round), int(max_iters)))

    def note_regime(self, kind: str, rounds: int, cap: int,
                    nonq_pairs: int, quiet_pairs: int, *, d: int, H: int,
                    hub_n: int, row_bytes: int) -> None:
        self.rounds += rounds
        if kind == "dense":
            self.dense_rounds += rounds
            self.bytes += rounds * d * (d - 1) * H * (row_bytes + 1)
        elif kind == "sparse":
            self.sparse_rounds += rounds
            self.bytes += nonq_pairs * cap * (row_bytes + 4)
            self.bytes += rounds * d * (d - 1) * 4        # per-pair count
            self.bytes += rounds * d * hub_n * (row_bytes + 1)  # hub lane
        else:
            self.local_rounds += rounds
            self.bytes += rounds * d * 4                  # liveness count
        self.quiet_pair_rounds += quiet_pairs
        self.nonquiet_pair_rounds += nonq_pairs

    def sync(self) -> "HaloTelemetry":
        for iters, bpr, max_iters in self._pending:
            r = min(int(iters), max_iters)
            self.rounds += r
            self.dense_rounds += r
            self.bytes += r * bpr
            self.fixpoints += 1
        self._pending.clear()
        return self

    def as_dict(self) -> dict:
        self.sync()
        return {"halo_bytes": int(self.bytes),
                "halo_rounds": int(self.rounds),
                "dense_rounds": int(self.dense_rounds),
                "sparse_rounds": int(self.sparse_rounds),
                "local_rounds": int(self.local_rounds),
                "quiet_pair_rounds": int(self.quiet_pair_rounds),
                "nonquiet_pair_rounds": int(self.nonquiet_pair_rounds),
                "fixpoints": int(self.fixpoints)}


def _pick_regime(cmax: int, hub_any: bool,
                 caps: tuple[int, ...]) -> tuple[str, int, int]:
    """(kind, cap, lo) for the global largest pair count ``cmax``."""
    if cmax == 0 and not hub_any:
        return "local", 0, 0
    for i, c in enumerate(caps):
        if cmax <= c:
            return "sparse", c, (caps[i - 1] if i else 0)
    return "dense", (caps[-1] if caps else 0), 0


def _fits(regime: tuple[str, int, int], cmax: int, hub_any: bool) -> bool:
    """Whether a regime still applies (the reference's loop condition).
    Dense with no sparse capacity (``cap == 0``) always does: once a
    fixpoint runs dense it stays dense, quiet rounds included."""
    kind, cap, lo = regime
    if kind == "dense":
        return cap == 0 or cmax > cap
    if kind == "sparse":
        if lo == 0:
            return cmax <= cap and (cmax > 0 or hub_any)
        return lo < cmax <= cap
    return cmax == 0 and not hub_any


class _Hubs:
    """This rank's view of the plan's hub lane for one direction."""

    def __init__(self, dp, n_loc: int, rank: int):
        lo = rank * n_loc
        self.owned = (dp.hubs >= lo) & (dp.hubs < lo + n_loc)
        self.loc = (dp.hubs - lo).clamp(0, n_loc - 1)
        self.n = int(dp.hubs.shape[0])
        self.not_hub = ~dp.h_hub
        # a pad hub's slot is n_loc + d*H: the combined table's dump row
        self.slot = dp.hub_slot

    def frontier(self, fr):
        return self.owned & fr[self.loc]

    def deliver(self, mesh, x, fr, comb, frc, dump: int):
        """The hub lane: one ``all_reduce(SUM)`` of the active hubs' rows
        with a flag column (the owner adds them, every other rank zeros),
        scattered into this rank's hub slots; inactive hubs go to the
        ``dump`` row."""
        hub_fr = self.frontier(fr)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        buf = torch.cat([torch.where(hub_fr[:, None], x[self.loc], zero),
                         hub_fr[:, None].to(x.dtype)], 1)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        slot = torch.where(buf[:, -1] != 0, self.slot, dump)
        comb[slot] = buf[:, :-1]
        frc[slot] = True


def _changed(dp, fr, hubs: _Hubs | None) -> torch.Tensor:
    """(d, H): which halo entries this rank sends are frontier rows,
    hub rows left out (they take the hub lane)."""
    sf = dp.h_valid & fr[dp.h_send]
    return sf if hubs is None else sf & hubs.not_hub


def _probe(mesh, dp, fr, hubs: _Hubs | None) -> tuple[np.ndarray, int, bool]:
    """One ``all_reduce`` and one host read: the (d, d) per-pair changed
    row counts (row = sender; hub rows left out), the global frontier
    count and whether any hub row is active, the same on every rank."""
    d = mesh.size
    t = torch.zeros(d * d + 2, dtype=torch.int64, device=fr.device)
    t[mesh.rank * d:(mesh.rank + 1) * d] = _changed(dp, fr, hubs).sum(1)
    t[d * d] = fr.sum()
    if hubs is not None:
        t[d * d + 1] = hubs.frontier(fr).sum()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    t = t.cpu().numpy()
    return t[:d * d].reshape(d, d), int(t[d * d]), bool(t[d * d + 1])


def _sparse_exchange(mesh, dp, x, fr, cap: int, hubs: _Hubs | None,
                     fill: int):
    """A sparse round: each pair's changed non-hub rows compacted into a
    ``cap``-row bucket (positions in the pair's halo list, -1 past the
    end) and sent by two ``all_to_all_single``, then the hub lane.  The
    caller's regime guarantees every pair fits.  Entries that do not
    travel are scattered into a dump column or row, as the reference's
    ``mode="drop"``, so the round reads nothing back to the host."""
    d, H = dp.h_send.shape
    n_loc, kf = x.shape
    dev = x.device
    sfc = _changed(dp, fr, hubs)
    at = torch.where(sfc, torch.cumsum(sfc, 1) - 1, cap)    # (d, H)
    col = torch.arange(H, dtype=torch.int32, device=dev).expand(d, H)
    posb = torch.full((d, cap + 1), -1, dtype=torch.int32, device=dev)
    posb.scatter_(1, at, col)
    valb = torch.zeros((d, cap + 1, kf), dtype=x.dtype, device=dev)
    valb.scatter_(1, at[..., None].expand(d, H, kf), x[dp.h_send])
    rpos = PL._exchange(mesh, posb[:, :cap])
    rval = PL._exchange(mesh, valb[:, :cap])
    comb, frc = _empty_table(x, fr, d, H, fill)
    dump = n_loc + d * H
    base = n_loc + torch.arange(d, device=dev)[:, None] * H
    slot = torch.where(rpos >= 0, base + rpos, dump).reshape(-1)
    comb[slot] = rval.reshape(-1, kf)
    frc[slot] = True
    if hubs is not None:
        hubs.deliver(mesh, x, fr, comb, frc, dump)
    return comb, frc


def _empty_table(x, fr, d: int, H: int, fill: int):
    """The combined table ``[local rows | d*H halo slots | dump row]``
    with the monoid's identity and no frontier in every halo slot, which
    the exchange then fills.  No bucket entry points at the dump row."""
    kf = x.shape[1]
    comb = torch.cat([x, torch.full((d * H + 1, kf), fill, dtype=x.dtype,
                                    device=x.device)])
    frc = torch.cat([fr, torch.zeros(d * H + 1, dtype=torch.bool,
                                     device=x.device)])
    return comb, frc


def _local_exchange(x, fr, d: int, H: int, fill: int):
    """A local round: nothing crosses, so only the local edges relax."""
    return _empty_table(x, fr, d, H, fill)


def sparse_halo_propagate(plan, x, frontier, live, *, reverse: bool = False,
                          max_iters: int = 256, monoid: str = "or",
                          plane_repr: str = "bool", telemetry=None,
                          caps=None) -> tuple[torch.Tensor, int]:
    """The sparse twin of ``planes.halo_propagate(halo_mode="dense")``:
    the same (rows, iters) with ``iters == max_iters + 1`` on truncation,
    bitwise equal, for bool and packed planes under OR and int32 planes
    under MIN.  ``caps`` overrides ``bucket_caps(H)`` (entries outside
    ``(0, H)`` are dropped: a bucket must be narrower than the dense
    exchange).  ``telemetry`` gets each regime's rounds and modeled bytes,
    and one fixpoint."""
    check_plane_repr(plane_repr)
    if monoid not in ("or", "min"):
        raise ValueError(f"unknown monoid {monoid!r}")
    if monoid == "min" and plane_repr == "packed":
        raise ValueError("plane_repr='packed' supports the OR monoid only")
    dp = plan.bwd if reverse else plan.fwd
    mesh = plan.mesh
    d, H = dp.h_send.shape
    if caps is None:
        caps = bucket_caps(H)
    else:
        caps = tuple(sorted({int(c) for c in caps if 0 < int(c) < H}))
    k = x.shape[1]
    n_loc = x.shape[0]
    packed = plane_repr == "packed"
    hubs = _Hubs(dp, n_loc, mesh.rank) \
        if plan.hub_count > 0 and dp.hubs is not None else None
    hub_n = hubs.n if hubs is not None else 0
    row_bytes = PL.halo_row_bytes(k, monoid, packed)
    relax = PL._relaxer(dp, live, monoid, packed, k)
    fill = INT_MAX if monoid == "min" else 0
    work = PL.PlaneStore.pack_rows(x) if packed else x
    # pairs with a halo list at all: a pair with none is never quiet
    has_halo = dp.host.h_valid.any(axis=2)                 # (d, d)
    fr = frontier.to(torch.bool)

    regime, run = None, [0, 0, 0]          # rounds, non-quiet, quiet pairs

    def note():
        if telemetry is not None and regime is not None and run[0]:
            telemetry.note_regime(regime[0], run[0], regime[1], run[1],
                                  run[2], d=d, H=H, hub_n=hub_n,
                                  row_bytes=row_bytes)

    cnt, front, hub_any = _probe(mesh, dp, fr, hubs)
    it = 0
    while front > 0 and it < max_iters:
        cmax = int(cnt.max())
        if regime is None or not _fits(regime, cmax, hub_any):
            note()
            regime, run = _pick_regime(cmax, hub_any, caps), [0, 0, 0]
        kind = regime[0]
        if kind == "dense":
            comb, frc = PL._dense_exchange(mesh, dp, work, fr, fill)
        elif kind == "sparse":
            comb, frc = _sparse_exchange(mesh, dp, work, fr, regime[1],
                                         hubs, fill)
        else:
            comb, frc = _local_exchange(work, fr, d, H, fill)
        run[0] += 1
        run[1] += int((cnt > 0).sum())
        run[2] += int((has_halo & (cnt == 0)).sum())
        work, fr = relax(work, comb, frc)
        it += 1
        cnt, front, hub_any = _probe(mesh, dp, fr, hubs)
    note()
    iters = max_iters + 1 if front > 0 and it >= max_iters else it
    if telemetry is not None:
        telemetry.fixpoints += 1
    out = PL.PlaneStore.unpack_rows(work, k, x.dtype) if packed else work
    return out, iters
