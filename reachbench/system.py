"""The system under test, built from a configuration: the port's DBL
index behind its ``ReachabilityServer``.  The only module of the harness
that imports the program (``repro_torch``); everything it hands over is
the benchmark's own generated data.
"""
from __future__ import annotations

import torch

from reachbench import spec


class System:
    """``query``/``insert``/``delete`` of one ``ReachabilityServer`` over a
    ``DBLIndex`` built from the graph's edges; ``m_cap`` slots leave room
    for the inserts."""

    def __init__(self, cfg: dict, src: torch.Tensor, dst: torch.Tensor,
                 m_cap: int, device):
        spec.use_src()
        from repro_torch.core.dbl import DBLIndex
        from repro_torch.core.graph import ALIVE, Graph
        from repro_torch.serve.engine import QueryEngine
        from repro_torch.serve.reach_server import ReachabilityServer

        n, m = int(cfg["graph"]["n"]), int(src.numel())
        ix, en = cfg["index"], cfg["engine"]
        i32 = dict(dtype=torch.int32, device=device)
        s = torch.zeros(m_cap, **i32)
        d = torch.zeros(m_cap, **i32)
        s[:m] = src
        d[:m] = dst
        g = Graph(s, d, torch.tensor(n, **i32), m,
                  torch.full((m_cap,), ALIVE, **i32))
        self.index = DBLIndex.build(
            g, n_cap=n, k=ix["k"], k_prime=ix["k_prime"],
            selection=ix["selection"], leaf_r=ix["leaf_r"],
            max_iters=ix["max_iters"], check=ix["check"],
            plane_repr=ix["plane_repr"], families=tuple(ix["families"]),
            device=device)
        self.engine = QueryEngine(
            self.index, bfs_chunk=en["bfs_chunk"], max_iters=en["max_iters"],
            backend=en["backend"], bfs_kernel=en["bfs_kernel"],
            streaming=en["streaming"], consistency=en["consistency"],
            frontier_dtype=en["frontier_dtype"], out_dtype=en["out_dtype"],
            plane_repr=ix["plane_repr"])
        sv = cfg["server"]
        self.server = ReachabilityServer(
            None, engine=self.engine,
            rebuild_dead_ratio=sv["rebuild_dead_ratio"],
            rebuild_mode=sv["rebuild_mode"])

    def warmup(self, batch_sizes) -> None:
        """The engine's ``warmup``: load the kernels and dispatch the label
        phase at each batch size and the residue at each of the engine's
        chunk buckets (the sizes a residue can be dispatched at)."""
        self.engine.warmup(self.engine.index, batch_sizes=tuple(batch_sizes),
                           bfs_buckets=self.engine._chunk_buckets())

    def query(self, u, v):
        return self.server.query(u, v)

    def insert(self, s, d) -> None:
        self.server.insert(s, d)

    def delete(self, s, d) -> None:
        self.server.delete(s, d)

    def counters(self) -> dict:
        """The program's counters: ``ServeStats`` and ``EngineStats``."""
        return {"serve": self.server.stats.as_dict(),
                "engine": self.engine.stats.as_dict()}

    def close(self) -> None:
        """Drop the program's state, so that its memory can be freed."""
        self.server = self.engine = self.index = None
