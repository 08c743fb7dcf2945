"""DAG-maintenance cost proxy (DAGGER's role in Figs 4-5).

TOL/IP require the SCC condensation (DAG) to be maintained under
insertions; the paper's point is that this maintenance, DAGGER, dominates
their update cost on real workloads.  The cost is modelled two ways:

1. ``scc_condense_numpy``: an exact Kosaraju SCC + condensation build on
   the host, the work DAGGER must (at least partly) redo when SCCs merge;
2. ``scc_fwbw_round``: one FW-BW "coloring" round on the graph's device,
   min-id forward and backward reachability by the same MIN-monoid
   fixpoint DBL uses; the vertices whose two colours both equal the pivot
   (the smallest unclassified id) form the pivot's SCC.  Iterated over the
   rest it is a full SCC algorithm; this is the per-round primitive an
   accelerator-resident DAGGER would be built from.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, edge_mask
from repro_torch.core.propagate import INT_MAX, propagate


def scc_condense_numpy(n: int, src: np.ndarray, dst: np.ndarray):
    """Exact SCCs (iterative Kosaraju) + condensation edge list.

    Returns (comp (n,), dag_src, dag_dst) with dag edges deduplicated.
    """
    adj = [[] for _ in range(n)]
    radj = [[] for _ in range(n)]
    for s, d in zip(src.tolist(), dst.tolist()):
        adj[s].append(d)
        radj[d].append(s)
    order = []
    seen = np.zeros(n, bool)
    for s in range(n):
        if seen[s]:
            continue
        stack = [(s, 0)]
        seen[s] = True
        while stack:
            v, i = stack.pop()
            if i < len(adj[v]):
                stack.append((v, i + 1))
                w = adj[v][i]
                if not seen[w]:
                    seen[w] = True
                    stack.append((w, 0))
            else:
                order.append(v)
    comp = np.full(n, -1, np.int64)
    c = 0
    for s in reversed(order):
        if comp[s] != -1:
            continue
        stack = [s]
        comp[s] = c
        while stack:
            v = stack.pop()
            for w in radj[v]:
                if comp[w] == -1:
                    comp[w] = c
                    stack.append(w)
        c += 1
    cs, cd = comp[src], comp[dst]
    keep = cs != cd
    dag = np.unique(np.stack([cs[keep], cd[keep]], 1), axis=0)
    return comp, dag[:, 0], dag[:, 1]


def scc_fwbw_round(g: Graph, unclassified: torch.Tensor, *, n_cap: int,
                   max_iters: int = 256):
    """One FW-BW coloring round on the ``unclassified`` (n_cap,) bool set.

    Returns (scc_mask, fwd_min, bwd_min): scc_mask marks the SCC of the
    smallest unclassified vertex id; the two (n_cap,) int32 colours are
    the least unclassified id that reaches each vertex, and that each
    vertex reaches (``INT_MAX`` for none)."""
    unclassified = unclassified.to(device=g.device, dtype=torch.bool)
    live = edge_mask(g)
    ids = torch.arange(n_cap, dtype=torch.int32, device=g.device)
    init = torch.where(unclassified, ids, INT_MAX)[:, None]
    fwd, _ = propagate(init, g.src, g.dst, live, unclassified, n_cap=n_cap,
                       monoid="min", max_iters=max_iters)
    bwd, _ = propagate(init, g.src, g.dst, live, unclassified, n_cap=n_cap,
                       monoid="min", max_iters=max_iters, reverse=True)
    pivot = init.min()
    scc = unclassified & (fwd[:, 0] == pivot) & (bwd[:, 0] == pivot)
    return scc, fwd[:, 0], bwd[:, 0]


def dag_stats(n: int, src: np.ndarray, dst: np.ndarray) -> dict:
    """|V|, |E| of the condensation: Table 2's DAG-|V| / DAG-|E| columns."""
    comp, ds, _ = scc_condense_numpy(n, src, dst)
    return {"dag_v": int(comp.max()) + 1, "dag_e": int(len(ds))}
