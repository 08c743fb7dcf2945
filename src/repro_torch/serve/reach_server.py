"""Batched reachability serving on a live, fully-dynamic DBL index.

The serving form of the paper's query workload: interleaved batches of
queries, edge insertions and edge deletions against one index, all through
the ``QueryEngine``.  Insertions bump the snapshot epoch without draining
in-flight queries; deletions tombstone edges (the labels go dirty) and the
labels are rebuilt lazily, scheduled once the tombstones pass
``rebuild_dead_ratio`` of the live edges and run at the next flush or
query boundary.

- synchronous ``query()``: submit and resolve in one call;
- pipelined ``submit()`` / ``flush()``: micro-batches accumulate across
  ``insert()`` calls and the flush pools their BFS residues across
  snapshot epochs.  ``consistency`` is ``"as-of-submit"`` (each query
  answered against the snapshot it observed) or ``"latest"``.

``vertex_mesh=`` serves a vertex-sharded index (``QueryEngine``'s
``vertex_mesh``): one process a shard, every rank making the same calls.
``mesh=`` (a ``distributed.query_mesh``) serves a replicated index with
each batch's label phase split over the ranks, again every rank making
the same calls.  ``aot_cache=DIR`` warms the engine's query phases from a
disk cache of ``torch.export`` programs (``serve.aot``) and fills it on
a miss; ``engine_stats()["aot"]`` counts its hits, misses and stores.

Tracing: while a ``torch.profiler`` records, the serving path records
named spans (``repro_torch.query`` with its ``.label`` and ``.residue``
phases and the residue's chunks and BFS rounds, ``repro_torch.insert``
with its fixpoints and rounds, ``repro_torch.delete``, and a
``repro_torch.sync.<site>`` span around every host read of the device,
``repro_torch.tracing``) in the same trace as the CUDA kernels; the
profiler is the operator's switch::

    with torch.profiler.profile() as prof:
        server.query(u, v)
    prof.export_chrome_trace("serve.json")

With no profiler recording, a span costs one check of its state.

    python -m repro_torch.serve.reach_server [--device cuda|cpu] \
        [--aot-cache DIR] ...
    torchrun --nproc_per_node N -m repro_torch.serve.reach_server \
        --vertex-shards N [--device cpu] ...
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.dbl import DBLIndex
from repro_torch.serve.engine import QueryEngine
from repro_torch.tracing import span


@dataclass
class ServeStats:
    queries: int = 0
    label_answered: int = 0
    bfs_answered: int = 0
    inserts: int = 0
    deletes: int = 0
    rebuilds: int = 0
    delta_rebuilds: int = 0
    flushes: int = 0
    query_s: float = 0.0
    insert_s: float = 0.0
    delete_s: float = 0.0
    rebuild_s: float = 0.0
    flush_s: float = 0.0

    def as_dict(self):
        rho = self.label_answered / max(self.queries, 1)
        return {"queries": self.queries, "rho": rho,
                "inserts": self.inserts, "deletes": self.deletes,
                "rebuilds": self.rebuilds,
                "delta_rebuilds": self.delta_rebuilds,
                "flushes": self.flushes,
                "query_s": self.query_s, "insert_s": self.insert_s,
                "delete_s": self.delete_s, "rebuild_s": self.rebuild_s,
                "flush_s": self.flush_s}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ReachabilityServer:
    """Serving over one engine: ``query``, ``submit``/``flush``/``poll``,
    ``insert`` (Alg 3; the pipeline rides across it), ``delete``
    (tombstones; in-flight submits drain first) and ``rebuild``.  The
    engine is built here from the knobs, or passed in ready-made.

    ``rebuild_dead_ratio`` is the laziness knob: once the tombstones reach
    that fraction of the live edge count, a rebuild is scheduled and runs
    at the next flush or query boundary, not inside ``delete``; ``None``
    rebuilds only when asked.  The live count, not the edge prefix ``m``
    that includes the tombstones, is the denominator.  ``rebuild_mode`` is
    passed to ``DBLIndex.rebuild``."""

    def __init__(self, index: DBLIndex | None, *, bfs_chunk: int = 256,
                 max_iters: int = 256, backend: str = "auto",
                 mesh=None, vertex_mesh=None,
                 engine: QueryEngine | None = None,
                 consistency: str = "as-of-submit",
                 rebuild_dead_ratio: float | None = 0.25,
                 rebuild_mode: str = "auto",
                 flush_policy: str | None = None,
                 flush_deadline_ms: float = 25.0,
                 flush_watermark: int = 256, device=None,
                 aot_cache: str | None = None):
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
                backend=backend, mesh=mesh, vertex_mesh=vertex_mesh,
                consistency=consistency,
                flush_policy=flush_policy,
                flush_deadline_ms=flush_deadline_ms,
                flush_watermark=flush_watermark, device=device)
        if self.engine.index is None:
            raise ValueError("server needs an index (directly or via engine)")
        if aot_cache is not None:
            # cold start: hits put loaded programs behind the engine's
            # phases, misses export this process's for the next start
            self.engine.aot_warmup(self.engine.index, aot_cache)
        if rebuild_dead_ratio is not None and not 0 < rebuild_dead_ratio <= 1:
            raise ValueError("rebuild_dead_ratio must be in (0, 1] or None")
        if rebuild_mode not in ("full", "delta", "auto"):
            raise ValueError(f"unknown rebuild mode {rebuild_mode!r}")
        self.rebuild_dead_ratio = rebuild_dead_ratio
        self.rebuild_mode = rebuild_mode
        self.stats = ServeStats()
        self._pending = []
        self._rebuild_due = False

    @property
    def index(self) -> DBLIndex:
        return self.engine.index

    @property
    def epoch(self) -> int:
        return self.engine.epoch

    @property
    def dirty(self) -> bool:
        return self.engine.index.is_dirty

    def query(self, u, v) -> np.ndarray:
        self._maybe_rebuild()
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
        dispatch sequence; returns their answers in submission order.  A
        scheduled lazy rebuild runs here, after the resolution."""
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
        self._maybe_rebuild()
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
        """Tombstone matching live edges and go dirty, without label
        recomputation.  Drains in-flight submits (``QueryEngine.delete``),
        then schedules a lazy rebuild if the tombstone ratio reached
        ``rebuild_dead_ratio``."""
        t = time.perf_counter()
        idx = self.engine.delete(np.asarray(src, np.int32),
                                 np.asarray(dst, np.int32))
        _sync(self.engine.device)
        self.stats.delete_s += time.perf_counter() - t
        self.stats.deletes += len(np.asarray(src))
        if self.rebuild_dead_ratio is not None and not self._rebuild_due:
            with span("repro_torch.sync.dead_edges"):
                dead = int(G.dead_edge_count(idx.graph))
            live = max(idx.graph.m - dead, 1)
            if dead / live >= self.rebuild_dead_ratio:
                self._rebuild_due = True

    def rebuild(self, **build_kw):
        """Rebuild the labels over the live edge set now (clears the dirty
        state, compacts tombstones, re-binds the engine after resolving
        in-flight submits).  ``mode`` defaults to ``rebuild_mode``."""
        build_kw.setdefault("mode", self.rebuild_mode)
        t = time.perf_counter()
        idx = self.engine.rebuild(**build_kw)
        _sync(self.engine.device)
        self.stats.rebuild_s += time.perf_counter() - t
        self.stats.rebuilds += 1
        if self.engine.last_rebuild_info["mode"] == "delta":
            self.stats.delta_rebuilds += 1
        self._rebuild_due = False
        # queued pendings were resolved by the re-bind's drain; they stay
        # queued so the next flush() still returns their answers in order
        return idx

    def _maybe_rebuild(self):
        if self._rebuild_due:
            self.rebuild()

    def engine_stats(self) -> dict:
        """The engine's counters, dispatch shapes and configuration, with
        the halo telemetry (all zero unless vertex-sharded) under ``halo``
        and its headline three at the top level, read fresh, and with an
        AOT cache its hits, misses and stores under ``aot``."""
        d = self.engine.stats.as_dict()
        d["dispatch_shapes"] = self.engine.dispatch_shapes()
        d["backend"] = self.engine.backend
        d["device"] = str(self.engine.device)
        d["epoch"] = self.engine.epoch
        d["consistency"] = self.engine.consistency
        d["dirty"] = self.dirty
        d["rebuild_due"] = self._rebuild_due
        d["rebuild_mode"] = self.rebuild_mode
        d["last_rebuild"] = self.engine.last_rebuild_info
        d["layout"] = self.engine.layout
        d["flush_policy"] = self.engine.flush_policy
        halo = self.engine.halo_stats()
        d["halo"] = {**halo, "mode": self.engine.halo_mode,
                     "hub_count": self.engine.hub_count}
        d.update({k: halo[k] for k in
                  ("halo_bytes", "halo_rounds", "quiet_pair_rounds")})
        if self.engine.aot_cache is not None:
            d["aot"] = {"hits": self.engine.aot_cache.hits,
                        "misses": self.engine.aot_cache.misses,
                        "stores": self.engine.aot_cache.stores}
        return d


def _vertex_world(shards: int, device):
    """The vertex mesh of a ``--vertex-shards`` run, and whether this call
    set up the process group (and so takes it down).  A group not set up
    yet is made from the launcher's environment (``torchrun``): NCCL on
    CUDA, gloo on the CPU."""
    import torch.distributed as dist

    from repro_torch.core.distributed import vertex_mesh
    from repro_torch.device import resolve_device
    own = not dist.is_initialized()
    if own:
        cpu = resolve_device(device).type == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://")
    try:
        return vertex_mesh(shards, device=device), own
    except BaseException:
        if own:
            dist.destroy_process_group()
        raise


def main(argv=None):
    """Serving driver: build an index over a generated power-law graph,
    run an interleaved query/insert stream, print stats as JSON.
    ``--aot-cache DIR`` round-trips the engine's label phase and residue
    programs through a ``torch.export`` disk cache: run twice with the
    same flags and the second start loads every program it stored (watch
    the ``aot`` counters).  ``--vertex-shards N`` serves it vertex-sharded
    over N ranks, one process each (``torchrun --nproc_per_node N``);
    rank 0 prints."""
    import argparse

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
    ap.add_argument("--aot-cache", default=None,
                    help="directory for the engine's torch.export'd "
                         "phases; a start with a warm cache loads them "
                         "instead of tracing")
    ap.add_argument("--flush-policy", default=None,
                    choices=["deadline", "watermark"])
    ap.add_argument("--vertex-shards", type=int, default=0,
                    help="serve with vertex-sharded label planes over this "
                         "many ranks (0 = replicated)")
    a = ap.parse_args(argv)

    vmesh, own_group = None, False
    if a.vertex_shards:
        vmesh, own_group = _vertex_world(a.vertex_shards, a.device)
    try:
        _serve(a, vmesh)
    finally:
        if own_group:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(a, vmesh):
    import json

    from repro_torch.core.graph import make_graph
    from repro_torch.graphs.generators import power_law

    dev = a.device if vmesh is None else vmesh.device
    src, dst = power_law(a.n, a.m, seed=0)
    g = make_graph(src, dst, a.n, m_cap=a.m + a.rounds * 64, device=dev)
    idx = DBLIndex.build(g, n_cap=a.n, k=a.k, k_prime=a.k, device=dev)
    t0 = time.perf_counter()
    srv = ReachabilityServer(idx, backend=a.backend, vertex_mesh=vmesh,
                             flush_policy=a.flush_policy,
                             aot_cache=a.aot_cache)
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
    if vmesh is not None and vmesh.rank:
        return
    print(json.dumps({"wall_s": time.perf_counter() - t0,
                      **srv.stats.as_dict(),
                      "engine": srv.engine_stats()}, indent=2, default=str))


if __name__ == "__main__":
    main()
