"""Synthetic graph generators (numpy), deterministic in ``seed``.

A copy of the reference generators, kept here so the port, its tests and
``chip_smoke.py`` make the same graphs from a seed without importing the
JAX package.
"""
from __future__ import annotations

import numpy as np


def power_law(n: int, m: int, *, alpha: float = 1.8, seed: int = 0,
              self_loops: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Directed power-law graph: endpoints drawn from a zipf-like rank
    distribution, so a few hubs cover most reachable pairs."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    src = rng.choice(n, size=m, p=p).astype(np.int32)
    dst = rng.choice(n, size=m, p=p).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)  # decouple hub ids
    src, dst = perm[src], perm[dst]
    if not self_loops:
        loop = src == dst
        dst[loop] = (dst[loop] + 1) % n
    return src, dst


def erdos_renyi(n: int, m: int, *, seed: int = 0
                ) -> tuple[np.ndarray, np.ndarray]:
    """Uniform random directed edges, self-loops moved one id on."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int32)
    dst = rng.integers(0, n, size=m, dtype=np.int32)
    loop = src == dst
    dst[loop] = (dst[loop] + 1) % n
    return src, dst


def dag_like(n: int, m: int, *, seed: int = 0, back_frac: float = 0.02
             ) -> tuple[np.ndarray, np.ndarray]:
    """Mostly-forward edges (sparse, poorly connected); ``back_frac`` of the
    edges close cycles so SCC merges occur under insertion."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, size=m, dtype=np.int32)
    b = rng.integers(0, n, size=m, dtype=np.int32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    eq = lo == hi
    hi[eq] = (hi[eq] + 1) % n
    lo[eq] = np.minimum(lo[eq], hi[eq])
    back = rng.random(m) < back_frac
    src = np.where(back, hi, lo)
    dst = np.where(back, lo, hi)
    return src.astype(np.int32), dst.astype(np.int32)


def molecules(batch: int, n_nodes: int, n_edges: int, *, seed: int = 0):
    """Batched small molecule-like graphs: positions, species and the
    ``n_edges`` shortest pairs of each graph as its edges.

    Returns (pos (B, N, 3) float32, species (B, N) int32, edge_index per
    graph (B, 2, E) int32)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=2.0, size=(batch, n_nodes, 3)).astype(np.float32)
    species = rng.integers(0, 8, size=(batch, n_nodes), dtype=np.int32)
    edges = np.zeros((batch, 2, n_edges), dtype=np.int32)
    for b in range(batch):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        order = np.argsort(d.ravel())[:n_edges]
        edges[b, 0] = (order // n_nodes).astype(np.int32)
        edges[b, 1] = (order % n_nodes).astype(np.int32)
    return pos, species, edges


# Table 2 statistic presets: (n, m, generator, kwargs).  The comments give
# the paper's full-size statistics; the presets keep their ratios.
TABLE2_PRESETS = {
    "LJ":       (60_000, 850_000, power_law, {"alpha": 1.7}),   # 4.8M/69M
    "Web":      (40_000, 230_000, power_law, {"alpha": 2.0}),   # 0.9M/5.1M
    "Email":    (30_000,  48_000, dag_like,  {"back_frac": 0.02}),  # 265K/420K
    "Wiki":     (60_000, 125_000, dag_like,  {"back_frac": 0.05}),  # 2.4M/5.0M
    "BerkStan": (35_000, 380_000, power_law, {"alpha": 1.5}),   # 685K/7.6M
    "Pokec":    (50_000, 940_000, power_law, {"alpha": 1.6}),   # 1.6M/31M
    "Twitter":  (70_000, 156_000, dag_like,  {"back_frac": 0.01}),  # 2.9M/6.4M
    "Reddit":   (55_000, 1_200_000, power_law, {"alpha": 1.6}), # 2.6M/57M
}


def table2_graph(name: str, *, seed: int = 0, scale: float = 1.0):
    """-> (n, src, dst) for a Table 2 preset scaled by ``scale``."""
    n, m, gen, kw = TABLE2_PRESETS[name]
    n, m = int(n * scale), int(m * scale)
    src, dst = gen(n, m, seed=seed, **kw)
    return n, src, dst
