"""A live reachability service on the PyTorch port over a growing graph:
interleaved batched queries and edge insertions (the Fig 4/5 workload),
each round checked against the port's B-BFS baseline.

    PYTHONPATH=src python examples/dynamic_reachability_torch.py \
        [--n 20000] [--rounds 10] [--queries 20000] [--inserts 100] \
        [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse
import time

import numpy as np

from repro_torch.baselines import bbfs
from repro_torch.core import DBLIndex, make_graph
from repro_torch.graphs.generators import power_law
from repro_torch.serve.reach_server import ReachabilityServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--m", type=int, default=120_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--queries", type=int, default=20_000)
    ap.add_argument("--inserts", type=int, default=100)
    ap.add_argument("--verify", type=int, default=200,
                    help="verify this many queries per round against B-BFS")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    src, dst = power_law(args.n, args.m, seed=0)
    g = make_graph(src, dst, args.n,
                   m_cap=args.m + args.rounds * args.inserts,
                   device=args.device)
    t0 = time.perf_counter()
    idx = DBLIndex.build(g, n_cap=args.n, k=64, k_prime=64, max_iters=64,
                         device=args.device)
    print(f"index built in {time.perf_counter() - t0:.2f}s "
          f"({idx.label_bytes() / 2**20:.1f} MiB labels, {idx.device})")

    server = ReachabilityServer(idx, bfs_chunk=64, max_iters=64)
    rng = np.random.default_rng(1)
    for r in range(args.rounds):
        u = rng.integers(0, args.n, args.queries).astype(np.int32)
        v = rng.integers(0, args.n, args.queries).astype(np.int32)
        ans = server.query(u, v)

        if args.verify:
            ref = bbfs.query(server.index.graph, u[:args.verify],
                             v[:args.verify], n_cap=args.n, chunk=64,
                             max_iters=64)
            if not (ans[:args.verify] == ref).all():
                raise SystemExit(f"round {r}: DBL diverged from B-BFS")

        ns = rng.integers(0, args.n, args.inserts).astype(np.int32)
        nd = rng.integers(0, args.n, args.inserts).astype(np.int32)
        server.insert(ns, nd)
        s = server.stats.as_dict()
        print(f"round {r}: {s['queries']} queries served "
              f"(ρ={s['rho']:.3f}), {s['inserts']} edges inserted, "
              f"query {s['query_s']:.2f}s / insert {s['insert_s']:.2f}s "
              f"cumulative")
    es = server.engine_stats()
    print(f"engine: backend={es['backend']} on {es['device']}, "
          f"{es['dispatch_shapes']} dispatch shapes, "
          f"{es['bfs_dispatches']} BFS dispatches for "
          f"{es['queries']} queries")
    print("all rounds verified against B-BFS — OK")


if __name__ == "__main__":
    main()
