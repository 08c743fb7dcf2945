"""Quickstart on the PyTorch port: build a DBL index, query, insert edges,
query again.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse

import numpy as np

from repro_torch.core import DBLIndex, make_graph
from repro_torch.graphs.generators import power_law


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n, m = 2_000, 12_000
    src, dst = power_law(n, m, seed=0)
    g = make_graph(src, dst, n, m_cap=m + 1_000,    # headroom for inserts
                   device=args.device)

    print(f"building DBL index on n={n}, m={m} ({g.device}) ...")
    idx = DBLIndex.build(g, n_cap=n, k=32, k_prime=32, max_iters=64,
                         device=args.device)
    print(f"label density: {idx.density()}")
    print(f"index size: {idx.label_bytes() / 1024:.1f} KiB")

    rng = np.random.default_rng(1)
    u = rng.integers(0, n, 10_000).astype(np.int32)
    v = rng.integers(0, n, 10_000).astype(np.int32)
    ans, stats = idx.query(u, v, return_stats=True)
    print(f"queries: {ans.sum()} reachable / {len(ans)}  "
          f"(ρ = {stats['rho']:.3f} answered by labels alone)")

    # dynamic updates: insert a batch of 50 random edges (Alg 3)
    ns = rng.integers(0, n, 50).astype(np.int32)
    nd = rng.integers(0, n, 50).astype(np.int32)
    idx = idx.insert_edges(ns, nd, max_iters=64)
    ans2, stats2 = idx.query(u, v, return_stats=True)
    print(f"after 50 inserts: {ans2.sum()} reachable "
          f"(+{int(ans2.sum()) - int(ans.sum())} new pairs), "
          f"ρ = {stats2['rho']:.3f}")
    if not (ans2 >= ans).all():
        raise SystemExit("reachability must be monotone under insertion")
    print("OK")


if __name__ == "__main__":
    main()
