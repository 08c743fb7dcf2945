"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample
of the query batches answered in the window, drawn from the seed, is
answered again by the plain reference (``reference.reach``) over the
benchmark's own edge set as that batch observed it (``Ledger.live_at``:
every insert and delete acknowledged before the batch, none after).  Of
each sampled batch a sample of its lanes is compared; of a further
sample of the batches that read their writes back (``traffic``), every
read-back lane too, so that an update acknowledged and not applied, or
applied late, shows.  The answers are exact booleans, so the comparison
is exact: one answer that differs is one mismatch, and the limit is 0.

The controls (run by ``control.py``, never by the benchmark's own
runs) put the reference in the program's place with one of the
configurations' stated guarantees broken:

- exact answers: ``control_depth<d>`` cuts the search at ``d`` rounds, as
  a bounded BFS would (``d`` = 2, 4, 8);
- as-of-submit consistency: ``control_frozen`` answers every sampled
  batch on the edge set as the window found it (updates deferred past
  the window), ``control_lag1`` on the edge set one update behind.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reachbench import reference

_STREAM_SAMPLE = 5


@dataclass
class Answered:
    """One query batch of the window: the updates it observed, its lanes
    (the read-back pairs, then the uniform lanes at ``where`` in the
    ``Pairs`` stream) and the program's answers (bit-packed)."""
    t: int
    size: int
    read_u: np.ndarray
    read_v: np.ndarray
    where: tuple
    answers: np.ndarray

    def pairs(self, uniform) -> tuple[np.ndarray, np.ndarray]:
        """(u, v) of every lane, from the ``Pairs`` stream ``uniform``."""
        pu, pv = uniform.get(self.where, self.size - self.read_u.size)
        return (np.concatenate([self.read_u, pu]),
                np.concatenate([self.read_v, pv]))


def sample(seed: int, answered: list, check: dict):
    """[(Answered, lane indices)]: ``check["batches"]`` of the window's
    query batches with ``check["lanes"]`` lanes of each (all of a smaller
    batch), and ``check["read_back_batches"]`` more of those that read
    writes back with every read-back lane, drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), _STREAM_SAMPLE])
    pick = rng.choice(len(answered),
                      size=min(check["batches"], len(answered)),
                      replace=False).tolist()
    lanes = {}
    for i in pick:
        a = answered[i]
        lanes[i] = rng.choice(a.size, size=min(check["lanes"], a.size),
                              replace=False)
    back = [i for i, a in enumerate(answered) if a.read_u.size]
    k = min(check.get("read_back_batches", 0), len(back))
    for i in (rng.choice(back, size=k, replace=False).tolist() if k
              else []):
        lanes[i] = np.union1d(lanes.get(i, []),
                              np.arange(answered[i].read_u.size))
    return [(answered[i], np.unique(lanes[i]).astype(np.int64))
            for i in sorted(lanes)]


CONTROL_DEPTHS = (2, 4, 8)


def _distances(ledger, n, t, u, v, device):
    live = ledger.live_at(t)
    return reference.distances(ledger.src[live], ledger.dst[live], n,
                               torch.from_numpy(u).to(device),
                               torch.from_numpy(v).to(device)).cpu().numpy()


def compare(seed: int, answered: list, ledger, uniform, n: int,
            check: dict, device, *, t_window: int | None = None) -> dict:
    """The counts of the comparison: lanes checked, read-back lanes among
    them, positives, mismatches; with ``t_window`` (the updates applied
    when the window opened) also the controls' mismatches."""
    out = {"batches_checked": 0, "lanes_checked": 0, "read_back_lanes": 0,
           "positives": 0, "mismatches": 0}
    controls = ([f"control_depth{d}" for d in CONTROL_DEPTHS]
                + ["control_frozen", "control_lag1"])
    if t_window is not None:
        out.update({c + "_mismatches": 0 for c in controls})
    for a, ln in sample(seed, answered, check):
        u, v = a.pairs(uniform)
        u, v = u[ln], v[ln]
        got = np.unpackbits(a.answers, count=a.size).astype(bool)[ln]
        dist = _distances(ledger, n, a.t, u, v, device)
        want = dist >= 0
        out["batches_checked"] += 1
        out["lanes_checked"] += len(ln)
        out["read_back_lanes"] += int((ln < a.read_u.size).sum())
        out["positives"] += int(want.sum())
        out["mismatches"] += int((got != want).sum())
        if t_window is None:
            continue
        ctl = {f"control_depth{d}": (dist >= 0) & (dist <= d)
               for d in CONTROL_DEPTHS}
        ctl["control_frozen"] = _distances(ledger, n, t_window, u, v,
                                           device) >= 0
        ctl["control_lag1"] = _distances(ledger, n, max(a.t - 1, 0), u, v,
                                         device) >= 0
        for c in controls:
            out[c + "_mismatches"] += int((ctl[c] != want).sum())
    return out
