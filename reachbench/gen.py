"""Directed Chung-Lu graphs, made on the device from a seed.

Vertex rank ``i`` carries the out-weight ``(i + i0) ** -beta`` and the
in-weight ``(i + i0) ** -beta_in`` (``beta_in`` defaults to ``beta``).
Each edge draws its tail from the out-weights and its head from the
in-weights
(``searchsorted`` over the cumulative weights), and a vertex permutation
maps ranks to ids: one permutation for both sides (``"shared"``: hubs send
and receive, as on a social graph) or one each (``"independent"``: the
heaviest senders are not the heaviest receivers, as on a talk graph),
except that the ``core`` heaviest ranks share their vertex (the active
users of a talk graph, who both write and receive).
Self-loops and repeated pairs are dropped and the count is topped back up,
so every edge is a distinct (tail, head) pair and holds one slot.

Every vertex of the graph has an edge, as in a published edge list (its
vertices are the endpoints it names): a vertex the draws left without one
gets one edge, as tail or head by its out- and in-weights, its partner
drawn from the other side's weights, and as many drawn edges between
vertices that keep another edge go, so that the count stays ``m``.

``chung_lu`` makes ``m + extra`` such edges in a seeded random order: the
first ``m`` are the graph, the rest the held-out edges that inserts append
later, in that order.  Plain torch on whatever device it is given; the
same seed on the same kind of device gives the same edges.
"""
from __future__ import annotations

import torch

#: the draws of one top-up round beyond the deficit, so that the last
#: rounds, where repeats are common, do not crawl
MIN_DRAW = 1 << 16
#: rounds of attaching vertices without an edge before giving up
ATTACH_ROUNDS = 64


def weights(n: int, beta: float, i0: float, device) -> torch.Tensor:
    """(n,) float64 endpoint weights by rank."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (i + float(i0)).pow(-float(beta))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def _ranks(cdf: torch.Tensor, count: int, gen: torch.Generator):
    x = torch.rand(count, dtype=torch.float64, device=cdf.device,
                   generator=gen) * cdf[-1]
    return torch.searchsorted(cdf, x, right=True).clamp_(max=cdf.numel() - 1)


def graph_args(graph: dict, scale: float = 1.0) -> dict:
    """``chung_lu``'s shape arguments from a configuration's ``graph``
    (``core`` scaled with n)."""
    return dict(beta=graph["beta"], i0=graph["i0"], perm=graph["perm"],
                beta_in=graph.get("beta_in"),
                core=int(round(graph.get("core", 0) * scale)))


def chung_lu(n: int, m: int, extra: int, *, beta: float, i0: float,
             perm: str, seed: int, device, core: int = 0,
             beta_in: float | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)``, each (m + extra,) int32 on ``device``: distinct
    pairs, no self-loop, in a seeded random order.  ``core``: how many of
    the heaviest ranks share their vertex under ``"independent"``."""
    if perm not in ("shared", "independent"):
        raise ValueError(f"unknown permutation rule {perm!r}")
    if not 0 <= core <= n:
        raise ValueError(f"core {core} outside 0..{n}")
    total = int(m) + int(extra)
    if total > n * (n - 1) // 4:
        raise ValueError(f"{total} distinct edges asked of {n} vertices")
    gen = generator(seed, 1, device)
    cdf = torch.cumsum(weights(n, beta, i0, device), 0)
    cdf_in = cdf if beta_in is None else torch.cumsum(
        weights(n, beta_in, i0, device), 0)
    p_out = torch.randperm(n, generator=gen, device=device)
    p_in = p_out
    if perm == "independent":
        rest = torch.randperm(n - core, generator=gen, device=device)
        p_in = torch.cat([p_out[:core], p_out[core:][rest]])
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < total:
        k = max(total - keys.numel(), MIN_DRAW)
        s = p_out[_ranks(cdf, k, gen)]
        d = p_in[_ranks(cdf_in, k, gen)]
        new = s[s != d] * n + d[s != d]
        keys = torch.unique(torch.cat([keys, new]))
    # a seeded subset of exactly ``total`` keys, in a seeded order
    keys = keys[torch.randperm(keys.numel(), generator=gen,
                               device=device)[:total]]
    sides = (cdf, p_out, _by_vertex(n, beta, i0, p_out)), \
        (cdf_in, p_in, _by_vertex(n, beta if beta_in is None else beta_in,
                                  i0, p_in))
    graph = _attach(keys[:m], keys[m:], n, sides, gen)
    keys = torch.cat([graph, keys[m:]])
    return (keys // n).to(torch.int32), (keys % n).to(torch.int32)


def _by_vertex(n: int, beta: float, i0: float, perm: torch.Tensor):
    """(n,) float64: each vertex's weight (its rank's under ``perm``)."""
    w = torch.empty(n, dtype=torch.float64, device=perm.device)
    w[perm] = weights(n, beta, i0, perm.device)
    return w


def _attach(graph: torch.Tensor, held: torch.Tensor, n: int, sides,
            gen: torch.Generator) -> torch.Tensor:
    """``graph``'s keys (tail * n + head) with an edge for every vertex
    that has none, the count kept: each such vertex takes one edge, as
    tail with the share of its out-weight in its two weights, its partner
    drawn by the other side's weights; as many drawn edges whose tail and
    head keep another edge go, drawn uniformly.  No new key repeats one
    of the graph or of ``held``; the result is in a seeded order."""
    (cdf_o, p_o, w_o), (cdf_i, p_i, w_i) = sides
    m = graph.numel()
    fixed = torch.zeros(m, dtype=torch.bool, device=graph.device)
    for _ in range(ATTACH_ROUNDS):
        s, d = graph // n, graph % n
        deg = torch.bincount(s, minlength=n) + torch.bincount(d, minlength=n)
        lone = torch.nonzero(deg == 0).squeeze(1)
        if lone.numel() == 0:
            break
        k = lone.numel()
        as_tail = torch.rand(k, dtype=torch.float64, device=graph.device,
                             generator=gen) * (w_o[lone] + w_i[lone]) \
            < w_o[lone]
        head = p_i[_ranks(cdf_i, k, gen)]
        tail = p_o[_ranks(cdf_o, k, gen)]
        new = torch.where(as_tail, lone * n + head, tail * n + lone)
        ok = (new // n != new % n) & ~torch.isin(new, held) \
            & ~torch.isin(new, graph)
        new = new[ok]
        new = new[_first(new)]
        # drop as many drawn edges between vertices that keep another edge
        can = torch.nonzero(~fixed & (deg[s] > 1) & (deg[d] > 1)).squeeze(1)
        new = new[:can.numel()]
        drop = can[torch.randperm(can.numel(), generator=gen,
                                  device=graph.device)[:new.numel()]]
        keep = torch.ones(m, dtype=torch.bool, device=graph.device)
        keep[drop] = False
        graph = torch.cat([graph[keep], new])
        fixed = torch.cat([fixed[keep],
                           torch.ones(new.numel(), dtype=torch.bool,
                                      device=graph.device)])
    else:
        raise RuntimeError(f"vertices without an edge after {ATTACH_ROUNDS}"
                           " rounds")
    return graph[torch.randperm(m, generator=gen, device=graph.device)]


def _first(keys: torch.Tensor) -> torch.Tensor:
    """(k,) bool: the first occurrence of each key."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((uniq.numel(),), keys.numel(), dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(keys.numel(),
                                               device=keys.device), "amin")
    out = torch.zeros(keys.numel(), dtype=torch.bool, device=keys.device)
    out[first] = True
    return out
