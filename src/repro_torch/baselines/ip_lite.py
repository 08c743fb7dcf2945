"""IP-lite: independent-permutation (k-min-wise) reachability labels.

IP's label for u is the k smallest hash values over Des(u) (resp. Anc(u)).
``u -> v`` implies Des(v) ⊆ Des(u) and Anc(u) ⊆ Anc(v), hence

    label_out(u) <= label_out(v)  and  label_in(v) <= label_in(u)  (elementwise)

so a violation certifies non-reachability (like BL); the other lanes fall
back to a label-pruned search (IP uses DFS; here the BFS lanes of DBL's
``query.pruned_bfs`` with IP's admit plane).

Scope: full IP also keeps per-vertex "level" labels and relies on DAGGER
for SCC maintenance; the ``dag_maintain`` proxy stands for that cost.
IP-lite is the dynamic-label essence on the same MIN-monoid fixpoint as
DBL (``propagate(monoid="min")``), which makes Fig-5-style update
comparisons like for like.  Every tensor lives on the graph's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.graph import Graph, edge_mask, insert_edges
from repro_torch.core.propagate import INT_MAX, propagate, seed_scatter_min


def _hashes(n_cap: int, k: int, seed: int = 0x9E3779B9) -> np.ndarray:
    """(n_cap, k) int32 independent vertex hashes (k "permutations"),
    non-negative.  uint32 arithmetic that wraps, in numpy: torch has no
    uint32 right shift on the CPU."""
    ids = np.arange(n_cap, dtype=np.uint32)[:, None]
    js = np.arange(k, dtype=np.uint32)[None, :]
    x = ids * np.uint32(2654435761) ^ (js * np.uint32(40503)
                                       + np.uint32(seed))
    x ^= x >> np.uint32(15)
    x *= np.uint32(2246822519)
    x ^= x >> np.uint32(13)
    return (x >> np.uint32(1)).astype(np.int32)


@dataclass
class IPIndex:
    graph: Graph
    label_in: torch.Tensor    # (n_cap, k) int32: min-hash over Anc(v)
    label_out: torch.Tensor   # (n_cap, k) int32: min-hash over Des(v)

    @property
    def n_cap(self) -> int:
        return self.label_in.shape[0]

    @staticmethod
    def build(g: Graph, *, n_cap: int, k: int = 8,
              max_iters: int = 256) -> "IPIndex":
        dev = g.device
        h = torch.from_numpy(_hashes(n_cap, k)).to(dev)
        valid = torch.arange(n_cap, device=dev) < g.n
        seed = torch.where(valid[:, None], h, INT_MAX)
        live = edge_mask(g)
        lin, _ = propagate(seed, g.src, g.dst, live, valid, n_cap=n_cap,
                           monoid="min", max_iters=max_iters)
        lout, _ = propagate(seed, g.src, g.dst, live, valid, n_cap=n_cap,
                            monoid="min", max_iters=max_iters, reverse=True)
        return IPIndex(g, lin, lout)

    def insert_edges(self, new_src, new_dst, *, max_iters: int = 256
                     ) -> "IPIndex":
        """The next snapshot: each new edge's endpoint labels MIN-combined
        (duplicate endpoints combine), then both fixpoints from the rows
        that fell."""
        dev = self.graph.device
        ns = torch.as_tensor(np.asarray(new_src, np.int32), device=dev)
        nd = torch.as_tensor(np.asarray(new_dst, np.int32), device=dev)
        n_cap = self.n_cap
        g2 = insert_edges(self.graph, ns, nd)
        live = edge_mask(g2)
        seeded_in, fr_in = seed_scatter_min(
            self.label_in, Q.rows(self.label_in, ns), nd, n_cap)
        lin, _ = propagate(seeded_in, g2.src, g2.dst, live, fr_in,
                           n_cap=n_cap, monoid="min", max_iters=max_iters,
                           inplace=True)
        seeded_out, fr_out = seed_scatter_min(
            self.label_out, Q.rows(self.label_out, nd), ns, n_cap)
        lout, _ = propagate(seeded_out, g2.src, g2.dst, live, fr_out,
                            n_cap=n_cap, monoid="min", max_iters=max_iters,
                            reverse=True, inplace=True)
        return IPIndex(g2, lin, lout)

    def query(self, u, v, *, chunk: int = 64,
              max_iters: int = 256) -> np.ndarray:
        """(Q,) np.bool_ answers: label verdicts for every lane, then the
        unknown lanes by pruned BFS, ``chunk`` at a time (padded with
        vertex 0)."""
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        dev = self.graph.device
        verd = ip_verdicts(self, torch.from_numpy(u).to(dev),
                           torch.from_numpy(v).to(dev)).cpu().numpy()
        out = verd == 1
        unknown = np.flatnonzero(verd == -1)
        for lo in range(0, unknown.size, chunk):
            idx = unknown[lo:lo + chunk]
            pad = chunk - idx.size
            uu = torch.from_numpy(np.pad(u[idx], (0, pad))).to(dev)
            vv = torch.from_numpy(np.pad(v[idx], (0, pad))).to(dev)
            hit = ip_pruned_bfs(self, uu, vv, n_cap=self.n_cap,
                                max_iters=max_iters).cpu().numpy()
            out[idx] = hit[:idx.size]
        return out


def ip_verdicts(idx: IPIndex, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """(Q,) int8: 0 certified unreachable, 1 trivially reachable (u == v),
    -1 unknown."""
    lout_u, lout_v = Q.rows(idx.label_out, u), Q.rows(idx.label_out, v)
    lin_u, lin_v = Q.rows(idx.label_in, u), Q.rows(idx.label_in, v)
    ok = (lout_u <= lout_v).all(-1) & (lin_v <= lin_u).all(-1)
    out = torch.where(ok, -1, 0).to(torch.int8)
    return torch.where(u == v, 1, out).to(torch.int8)


def ip_pruned_bfs(idx: IPIndex, u: torch.Tensor, v: torch.Tensor, *,
                  n_cap: int, max_iters: int = 256) -> torch.Tensor:
    """(Q,) bool: BFS lanes that admit x only where the labels do not
    already rule out x -> v: x -> v implies Des(v) ⊆ Des(x), so
    label_out(x) <= label_out(v).  The admit plane is an (n_cap, Q, k)
    comparison reduced over k."""
    lout_v = Q.rows(idx.label_out, v)
    admit = (idx.label_out[:, None, :] <= lout_v[None, :, :]).all(-1)
    return Q.pruned_bfs(idx.graph, None, u, v, admit, n_cap=n_cap,
                        max_iters=max_iters)
