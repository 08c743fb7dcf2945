"""Batched reachability serving on a live DBL index.

The serving form of the paper's query workload: interleaved batches of
queries and edge insertions against one index, all through the
``QueryEngine``.  Insertions bump the snapshot epoch without draining
in-flight queries.

- synchronous ``query()``: submit and resolve in one call;
- pipelined ``submit()`` / ``flush()``: micro-batches accumulate across
  ``insert()`` calls and the flush pools their BFS residues across
  snapshot epochs.  ``consistency`` is ``"as-of-submit"`` (each query
  answered against the snapshot it observed) or ``"latest"``.

Deletions and the lazy rebuild come in a later slice.

    python -m repro_torch.serve.reach_server [--device cuda|cpu] ...
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.dbl import DBLIndex, not_ported
from repro_torch.serve.engine import QueryEngine


@dataclass
class ServeStats:
    queries: int = 0
    label_answered: int = 0
    bfs_answered: int = 0
    inserts: int = 0
    flushes: int = 0
    query_s: float = 0.0
    insert_s: float = 0.0
    flush_s: float = 0.0

    def as_dict(self):
        rho = self.label_answered / max(self.queries, 1)
        return {"queries": self.queries, "rho": rho,
                "inserts": self.inserts, "flushes": self.flushes,
                "query_s": self.query_s, "insert_s": self.insert_s,
                "flush_s": self.flush_s}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ReachabilityServer:
    """Serving over one engine: ``query``, ``submit``/``flush``/``poll``
    and ``insert`` (Alg 3; the pipeline rides across it).  The engine is
    built here from the knobs, or passed in ready-made."""

    def __init__(self, index: DBLIndex | None, *, bfs_chunk: int = 256,
                 max_iters: int = 256, backend: str = "auto",
                 engine: QueryEngine | None = None,
                 consistency: str = "as-of-submit",
                 flush_policy: str | None = None,
                 flush_deadline_ms: float = 25.0,
                 flush_watermark: int = 256, device=None):
        if engine is not None:
            if engine.index is not None and index is not None \
                    and engine.index is not index:
                raise ValueError(
                    "both `index` and an engine with a bound index were "
                    "given; pass one or the other")
            self.engine = engine
            if engine.index is None:
                engine.index = index
        else:
            self.engine = QueryEngine(
                index, bfs_chunk=bfs_chunk, max_iters=max_iters,
                backend=backend, consistency=consistency,
                flush_policy=flush_policy,
                flush_deadline_ms=flush_deadline_ms,
                flush_watermark=flush_watermark, device=device)
        if self.engine.index is None:
            raise ValueError("server needs an index (directly or via engine)")
        self.stats = ServeStats()
        self._pending = []

    @property
    def index(self) -> DBLIndex:
        return self.engine.index

    @property
    def epoch(self) -> int:
        return self.engine.epoch

    def query(self, u, v) -> np.ndarray:
        t = time.perf_counter()
        ans, info = self.engine.query(np.asarray(u, np.int32),
                                      np.asarray(v, np.int32),
                                      return_stats=True)
        self.stats.query_s += time.perf_counter() - t
        self.stats.queries += len(ans)
        self.stats.bfs_answered += info["n_bfs"]
        self.stats.label_answered += len(ans) - info["n_bfs"]
        return ans

    def submit(self, u, v):
        """Enqueue a micro-batch against the current snapshot epoch: the
        label phase runs now, the BFS residue rides the next flush."""
        t = time.perf_counter()
        pend = self.engine.submit(self.engine.index,
                                  np.asarray(u, np.int32),
                                  np.asarray(v, np.int32))
        self._pending.append(pend)
        self.stats.query_s += time.perf_counter() - t
        return pend

    def flush(self, *, consistency: str | None = None) -> list:
        """Resolve every outstanding micro-batch in one epoch-coalesced
        dispatch sequence; returns their answers in submission order."""
        t = time.perf_counter()
        pending = self._pending
        outs = self.engine.flush(pending, consistency=consistency)
        self._pending = []
        self.stats.flush_s += time.perf_counter() - t
        self.stats.flushes += 1
        for pend, ans in zip(pending, outs):
            self.stats.queries += len(ans)
            self.stats.bfs_answered += pend.nu
            self.stats.label_answered += len(ans) - pend.nu
        return outs

    def poll(self) -> bool:
        """Give the engine's flush policy a chance to run (a deadline must
        fire without new traffic).  True when it flushed."""
        return self.engine.maybe_flush()

    def insert(self, src, dst):
        """Alg-3 insert: bumps the snapshot epoch; outstanding submits stay
        in flight and resolve with as-of-submit cutoffs at flush."""
        t = time.perf_counter()
        self.engine.insert(np.asarray(src, np.int32),
                           np.asarray(dst, np.int32))
        _sync(self.engine.device)
        self.stats.insert_s += time.perf_counter() - t
        self.stats.inserts += len(np.asarray(src))

    def delete(self, src, dst):
        raise not_ported("ReachabilityServer.delete", "queue 1, item 11")

    def rebuild(self, **build_kw):
        raise not_ported("ReachabilityServer.rebuild", "queue 1, item 11")

    def engine_stats(self) -> dict:
        d = self.engine.stats.as_dict()
        d["backend"] = self.engine.backend
        d["device"] = str(self.engine.device)
        d["epoch"] = self.engine.epoch
        d["consistency"] = self.engine.consistency
        d["flush_policy"] = self.engine.flush_policy
        return d


def main(argv=None):
    """Serving driver: build an index over a generated power-law graph,
    run an interleaved query/insert stream, print stats as JSON."""
    import argparse
    import json

    from repro_torch.core.graph import make_graph
    from repro_torch.graphs.generators import power_law

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run "
                         "on the CPU)")
    ap.add_argument("--flush-policy", default=None,
                    choices=["deadline", "watermark"])
    a = ap.parse_args(argv)

    src, dst = power_law(a.n, a.m, seed=0)
    g = make_graph(src, dst, a.n, m_cap=a.m + a.rounds * 64,
                   device=a.device)
    idx = DBLIndex.build(g, n_cap=a.n, k=a.k, k_prime=a.k, device=a.device)
    t0 = time.perf_counter()
    srv = ReachabilityServer(idx, backend=a.backend,
                             flush_policy=a.flush_policy)
    rng = np.random.default_rng(0)
    for r in range(a.rounds):
        u = rng.integers(0, a.n, a.batch).astype(np.int32)
        v = rng.integers(0, a.n, a.batch).astype(np.int32)
        srv.submit(u, v)
        if r % 2:
            srv.insert(rng.integers(0, a.n, 64).astype(np.int32),
                       rng.integers(0, a.n, 64).astype(np.int32))
        srv.poll()
    srv.flush()
    print(json.dumps({"wall_s": time.perf_counter() - t0,
                      **srv.stats.as_dict(),
                      "engine": srv.engine_stats()}, indent=2, default=str))


if __name__ == "__main__":
    main()
