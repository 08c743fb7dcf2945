"""The one traffic generator: a mix file's step, drawn from the seed, and
the benchmark's own record of which edge is live at which update.

A mix is a closed loop of one client that repeats a step until the window
closes.  A step is a list of operations, each ``{"op": "query" |
"insert" | "delete", "repeat": r, "size": s}``: ``r`` batches of ``s``
query pairs, held-out edges (in the generator's order) or live edges
(drawn uniformly).  The first query batch after one or more updates
reads its writes back: its first lanes ask, for each of those updates,
whether the tail of each of its first ``read_your_writes`` edges reaches
the head; the other lanes are uniform random pairs.  ``held_out`` is how
many held-out edges the configuration's generator makes beside the
graph (the server's edge capacity is the graph's edges and these):
about twice what a window inserts, so that a program twice as fast
still fills its window.  ``query_lanes`` uniform lanes are drawn in
set-up, about twice what a window asks; a window that asks more draws
more as it goes.  ``warm_steps`` steps run untimed in set-up.  ``check``
says how many query batches and lanes a batch the comparison with the
reference takes, and how many batches that read writes back have those
lanes checked whole (``read_back_batches``).

Every batch's content is a function of the seed and its position alone:
the uniform lanes are one stream taken in order, inserts take the
held-out edges in order, deletes draw from one stream over the live
edges.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from reachbench.gen import generator

#: ``born``/``died`` of an edge not (yet) inserted / never deleted
NEVER = np.iinfo(np.int32).max
_STREAM_QUERY, _STREAM_DELETE = 2, 3
OPS = ("query", "insert", "delete")
#: uniform lanes drawn at once (fewer where fewer are asked for, but no
#: fewer than ``MIN_CHUNK``)
CHUNK, MIN_CHUNK = 1 << 22, 1 << 16


def step_ops(mix: dict) -> list[tuple[str, int]]:
    """The mix's step as a flat list of (operation, batch size)."""
    out = []
    for op in mix["step"]:
        if op["op"] not in OPS:
            raise ValueError(f"unknown operation {op['op']!r}")
        out += [(op["op"], int(op["size"]))] * int(op.get("repeat", 1))
    return out


class Pairs:
    """The uniform query lanes: one stream of (u, v) pairs over the ``n``
    vertices, drawn on the device from the seed in chunks and kept on the
    host; at least ``lanes`` are drawn at once.  A batch takes the next
    lanes of one chunk (a chunk's tail too short for it is skipped)."""

    def __init__(self, seed: int, n: int, lanes: int, device):
        self.n = int(n)
        self.device = device
        self.chunk = min(CHUNK, max(int(lanes), MIN_CHUNK))
        self.gen = generator(seed, _STREAM_QUERY, device)
        self.chunks: list[np.ndarray] = []
        self.at = (0, 0)
        while len(self.chunks) * self.chunk < lanes:
            self._draw()

    def _draw(self) -> None:
        uv = torch.randint(0, self.n, (2, self.chunk), generator=self.gen,
                           device=self.device, dtype=torch.int32)
        self.chunks.append(uv.cpu().numpy())

    def take(self, size: int) -> tuple[int, int]:
        """The (chunk, offset) of the next ``size`` lanes."""
        if size > self.chunk:
            raise ValueError(f"a batch of {size} lanes; at most "
                             f"{self.chunk}")
        c, o = self.at
        if o + size > self.chunk:
            c, o = c + 1, 0
        while c >= len(self.chunks):
            self._draw()
        self.at = (c, o + size)
        return c, o

    def get(self, where: tuple[int, int], size: int):
        """(u, v), each (size,) int32, of the lanes at ``where``."""
        c, o = where
        return self.chunks[c][0, o:o + size], self.chunks[c][1, o:o + size]


@dataclass
class Ledger:
    """The benchmark's own edge set: every generated edge (graph first,
    then held-out in insertion order) with the update that inserted it
    (``born``; 0 for the graph) and the update that deleted it
    (``died``).  Updates are counted from 1; a query batch that observed
    ``t`` updates sees the edges with ``born <= t < died``."""

    src: torch.Tensor          # (T,) int32, on the device
    dst: torch.Tensor
    born: torch.Tensor         # (T,) int32
    died: torch.Tensor
    m: int                     # the graph's edges
    host_src: np.ndarray       # (T - m,) int32: the held-out edges, for
    host_dst: np.ndarray       # the server's insert calls
    inserted: int = 0          # held-out edges inserted so far
    t: int = 0                 # updates applied so far
    unread: list = field(default_factory=list)  # updates since the last
                                                # query batch: (src, dst)

    @classmethod
    def of(cls, src: torch.Tensor, dst: torch.Tensor, m: int) -> "Ledger":
        born = torch.full_like(src, NEVER)
        born[:m] = 0
        return cls(src, dst, born, torch.full_like(src, NEVER), int(m),
                   src[m:].cpu().numpy(), dst[m:].cpu().numpy())

    @property
    def held_out_left(self) -> int:
        return self.src.numel() - self.m - self.inserted

    def live_at(self, t: int) -> torch.Tensor:
        """(T,) bool: the edges a batch that observed ``t`` updates sees."""
        return (self.born <= t) & (self.died > t)

    def take_inserts(self, size: int):
        """The next ``size`` held-out edges as host arrays, recorded as
        inserted by the next update.  None when fewer are left."""
        if self.held_out_left < size:
            return None
        lo = self.inserted
        self.inserted += size
        self.t += 1
        self.born[self.m + lo:self.m + lo + size] = self.t
        out = self.host_src[lo:lo + size], self.host_dst[lo:lo + size]
        self.unread.append(out)
        return out

    def take_deletes(self, size: int, gen: torch.Generator):
        """``size`` distinct live edges drawn uniformly (rejection over the
        slots in use), recorded as deleted by the next update."""
        top = self.m + self.inserted
        picked = torch.empty(0, dtype=torch.int64, device=self.src.device)
        while picked.numel() < size:
            cand = torch.randint(0, top, (2 * size,), generator=gen,
                                 device=self.src.device)
            cand = cand[self.died[cand] == NEVER]
            cand = cand[~torch.isin(cand, picked)]
            # first occurrences, in draw order
            uniq, inv = torch.unique(cand, return_inverse=True)
            first = torch.full((uniq.numel(),), cand.numel(),
                               dtype=torch.int64, device=cand.device)
            first.scatter_reduce_(0, inv, torch.arange(
                cand.numel(), device=cand.device), "amin")
            picked = torch.cat([picked, cand[first.sort().values]])
        picked = picked[:size]
        self.t += 1
        self.died[picked] = self.t
        out = (self.src[picked].cpu().numpy(),
               self.dst[picked].cpu().numpy())
        self.unread.append(out)
        return out

    def read_back(self, per_update: int):
        """(u, v) int32: the tail and head of the first ``per_update`` edges
        of each update since the last call, in update order."""
        parts, self.unread = self.unread, []
        u = [s[:per_update] for s, _ in parts]
        v = [d[:per_update] for _, d in parts]
        if not u:
            return (np.zeros(0, np.int32),) * 2
        return (np.concatenate(u).astype(np.int32),
                np.concatenate(v).astype(np.int32))


def delete_generator(seed: int, device) -> torch.Generator:
    return generator(seed, _STREAM_DELETE, device)
