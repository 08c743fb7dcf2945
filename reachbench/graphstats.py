"""Shape statistics of a configuration's generated graph, beside its
source's: the largest strongly and weakly connected components' shares of
the vertices, the distinct edges, and the vertices with both an in-edge
and an out-edge.  Counted on the host with scipy's component routine.

    python -m reachbench.graphstats --config lj [--seed 0] [--scale 0.1]
        [--beta 1.1] [--device cuda|cpu]

``--scale`` shrinks n and m together (a calibration of ``beta`` on a
small host), ``--beta``/``--i0`` override the file's.  Prints one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def graph_stats(src: np.ndarray, dst: np.ndarray, n: int) -> dict:
    """The shape statistics of the graph ``src -> dst`` on ``n`` vertices."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    a = coo_matrix((np.ones(src.size, np.int8), (src, dst)),
                   shape=(n, n)).tocsr()
    out = {"n": int(n), "m": int(src.size),
           "distinct_edges": int(np.unique(src * n + dst).size),
           "self_loops": int((src == dst).sum())}
    for kind in ("strong", "weak"):
        _, lab = connected_components(a, directed=True, connection=kind)
        big = int(np.bincount(lab).max())
        out[f"largest_{'scc' if kind == 'strong' else 'wcc'}"] = big
        out[f"largest_{'scc' if kind == 'strong' else 'wcc'}_share"] = \
            big / n
    has_in = np.zeros(n, bool)
    has_out = np.zeros(n, bool)
    has_in[dst] = True
    has_out[src] = True
    out["in_and_out_vertices"] = int((has_in & has_out).sum())
    out["in_and_out_share"] = float((has_in & has_out).mean())
    return out


def pair_stats(src, dst, n: int, seed: int, device, pairs: int = 1024
               ) -> dict:
    """Of ``pairs`` uniform pairs: the reachable share, and the 10th, 50th
    and 90th percentiles of the shortest-path lengths of the reachable
    ones (the plain reference's BFS)."""
    import torch

    from reachbench.reference import distances
    rng = np.random.default_rng([seed, 7])
    u, v = (torch.from_numpy(rng.integers(0, n, pairs)).to(device)
            for _ in range(2))
    d = distances(src, dst, n, u, v).cpu().numpy()
    pos = d[d >= 0]
    return {"pairs": pairs, "reachable_share": float(pos.size / pairs),
            "distance_p10_p50_p90": [float(x) for x in np.percentile(
                pos, [10, 50, 90])] if pos.size else None}


def main(argv=None) -> int:
    import torch

    from reachbench import spec

    from reachbench.gen import chung_lu, graph_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--i0", type=float, default=None)
    ap.add_argument("--beta-in", type=float, default=None)
    ap.add_argument("--core", type=int, default=None,
                    help="shared heaviest ranks at full size")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cfg = spec.config(a.config)
    g = cfg["graph"]
    n = int(round(g["n"] * a.scale))
    m = int(round(g["m"] * a.scale))
    for key, val in (("beta", a.beta), ("i0", a.i0), ("beta_in", a.beta_in),
                     ("core", a.core)):
        if val is not None:
            g[key] = val
    kw = graph_args(g, a.scale)
    dev = torch.device(a.device)
    t = time.perf_counter()
    src, dst = chung_lu(n, m, 0, seed=a.seed, device=dev, **kw)
    gen_s = time.perf_counter() - t
    st = graph_stats(src.cpu().numpy(), dst.cpu().numpy(), n)
    st.update(pair_stats(src, dst, n, a.seed, dev))
    print(json.dumps({"config": a.config, "scale": a.scale, **kw,
                      "seed": a.seed, "device": a.device,
                      "generate_s": gen_s, **st}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
