"""Time the replicated engine's query rounds of several source trees of
this repo, in turns, on one card.

Each side is a tree and an engine, ``TREE:ENGINE``; it serves in a
worker process of its own, started in that tree with its ``src`` on the
path, over the same LJ-preset index (``table2_graph("LJ")``, n 60 000,
m 850 000, k = k' = 64, ``max_iters`` 64, as ``chip_smoke.py``'s main
path builds it).  The driver then asks the sides for one round each,
in the order of the command line and then reversed (A B B A ...), for
``--pairs`` such turns, so that every side sees the card in the same
states.  A round is ``ReachabilityServer.query`` of ``QUERIES`` uniform
random pairs, the same batch on every side (``BATCHES`` of them in
turn), timed on the host clock with the card synchronised before and
after.  Every side's answers must equal the first side's, bit for bit.

Engines (``ENGINES``): ``main`` is the main path's
``QueryEngine(bfs_chunk=64, max_iters=64, bfs_kernel=True)``;
``packed`` adds ``frontier_dtype="packed"`` (the BFS on words of 32
lanes); ``aot`` is ``main`` served through programs loaded by
``aot_warmup`` from a cache that a first engine of the same worker
stored (under the tree's ``build/``, removed at the end).

    python tools/compare_rounds.py OLD:main NEW:main NEW:aot \\
        [--pairs 20] [--kernel-times] [--out FILE]

A rehearsal on the CPU: ``--device cpu --scale 0.02`` (no
``--kernel-times``).

``--kernel-times`` also runs each ``main`` side's own
``chip_smoke.kernel_timings`` twice, in the same turns: device and
host-loop ms a launch of each kernel.  Prints the card's line, one JSON
line a round and a summary line a side (median, quartiles, min and max
of the round ms); ``--out`` writes the whole record as JSON too.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

QUERIES = 20_000
BATCHES = 4
ENGINES = {"main": dict(bfs_kernel=True),
           "packed": dict(bfs_kernel=True, frontier_dtype="packed"),
           "aot": dict(bfs_kernel=True)}
REPLY = "@@"


# ------------------------------------------------------------------ worker
def worker(engine: str, device: str, scale: float) -> None:
    """Serve one side: build the index and the engine, then answer the
    driver's commands (one JSON line each on stdin) with one line each on
    stdout, prefixed ``REPLY``."""
    import numpy as np
    import torch
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n, src, dst = table2_graph("LJ", scale=scale, seed=0)
    g = make_graph(src, dst, n, m_cap=int(src.size), device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, max_iters=64,
                         check="raise", device=dev)
    eng = QueryEngine(idx, bfs_chunk=64, max_iters=64, **ENGINES[engine])
    cache = None
    if engine == "aot":
        cache = Path("build") / f"compare_rounds_aot_{os.getpid()}"
        QueryEngine(idx, bfs_chunk=64, max_iters=64,
                    **ENGINES[engine]).aot_warmup(idx, cache,
                                                  batch_sizes=(QUERIES,))
        eng.aot_warmup(idx, cache, batch_sizes=(QUERIES,))
        if eng.aot_cache.misses or not eng.aot_cache.hits:
            raise AssertionError(f"aot: {eng.aot_cache.hits} hits, "
                                 f"{eng.aot_cache.misses} misses")
    srv = ReachabilityServer(engine=eng, index=None)
    rng = np.random.default_rng(7)
    batches = [(rng.integers(0, n, QUERIES).astype(np.int32),
                rng.integers(0, n, QUERIES).astype(np.int32))
               for _ in range(BATCHES)]
    for u, v in batches:
        srv.query(u, v)                                  # warm-up
    sync()
    print(REPLY + json.dumps({"ready": True}), flush=True)
    try:
        for line in sys.stdin:
            cmd = json.loads(line)
            if cmd["op"] == "round":
                u, v = batches[cmd["batch"] % BATCHES]
                sync()
                t = time.perf_counter()
                ans = srv.query(u, v)
                sync()
                ms = (time.perf_counter() - t) * 1e3
                out = {"ms": ms, "answers": np.packbits(ans).tobytes().hex()}
            elif cmd["op"] == "kernel_times":
                sys.path.insert(0, os.getcwd())
                import chip_smoke
                t = chip_smoke.kernel_timings(dev)
                out = {k: {"ms": r["ms"], "host_loop_ms": r["host_loop_ms"]}
                       for k, r in t.items()}
            else:
                break
            print(REPLY + json.dumps(out), flush=True)
    finally:
        if cache is not None:
            shutil.rmtree(cache, ignore_errors=True)


# ------------------------------------------------------------------ driver
class Side:
    def __init__(self, spec: str, device: str, scale: float):
        tree, _, engine = spec.rpartition(":")
        if engine not in ENGINES or not tree:
            raise SystemExit(f"a side is TREE:ENGINE with ENGINE one of "
                             f"{sorted(ENGINES)}, got {spec!r}")
        self.spec, self.tree, self.engine = spec, Path(tree).resolve(), engine
        env = {**os.environ, "PYTHONPATH": str(self.tree / "src")}
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             engine, "--device", device, "--scale", str(scale)],
            cwd=self.tree, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)

    def ask(self, cmd=None) -> dict:
        if cmd is not None:
            self.proc.stdin.write(json.dumps(cmd) + "\n")
            self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith(REPLY):
                return json.loads(line[len(REPLY):])
        raise RuntimeError(f"{self.spec}: the worker ended "
                           f"(rc {self.proc.wait()})")

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def _quantiles(xs):
    s = sorted(xs)

    def q(f):
        return s[min(len(s) - 1, int(round(f * (len(s) - 1))))]
    return {"n": len(s), "median": q(0.5), "q25": q(0.25), "q75": q(0.75),
            "min": s[0], "max": s[-1]}


def _card_line(device: str) -> str:
    if device != "cuda":
        return device
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def drive(specs, pairs: int, kernel_times: bool, device: str = "cuda",
          scale: float = 1.0) -> dict:
    card = _card_line(device)
    print(card, flush=True)
    sides = [Side(s, device, scale) for s in specs]
    try:
        for s in sides:
            s.ask()                                      # ready
        rounds = {s.spec: [] for s in sides}
        for i in range(pairs):
            order = sides if i % 2 == 0 else sides[::-1]
            want = None
            for s in order:
                r = s.ask({"op": "round", "batch": i})
                if want is None:
                    want = r["answers"]
                elif r["answers"] != want:
                    raise AssertionError(f"turn {i}: {s.spec}'s answers "
                                         "differ from the other sides'")
                rounds[s.spec].append(r["ms"])
                print(json.dumps({"turn": i, "side": s.spec,
                                  "ms": r["ms"]}), flush=True)
        kernels = {}
        if kernel_times:
            timed = [s for s in sides if s.engine == "main"]
            for order in (timed, timed[::-1]):
                for s in order:
                    kernels.setdefault(s.spec, []).append(
                        s.ask({"op": "kernel_times"}))
    finally:
        for s in sides:
            s.close()
    summary = {spec: _quantiles(ms) for spec, ms in rounds.items()}
    for spec, q in summary.items():
        print(json.dumps({"side": spec, "round_ms": q, "card": card}),
              flush=True)
    for spec, runs in kernels.items():
        print(json.dumps({"side": spec, "kernel_times": runs,
                          "card": card}), flush=True)
    return {"card": card, "queries": QUERIES, "pairs": pairs,
            "rounds": rounds, "summary": summary, "kernel_times": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sides", nargs="*", help="TREE:ENGINE, at least two")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--kernel-times", action="store_true")
    ap.add_argument("--out")
    # a rehearsal on the CPU: --device cpu at a small --scale of the graph
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.device, args.scale)
        return 0
    if len(args.sides) < 2:
        ap.error("give at least two sides")
    if args.kernel_times and args.device != "cuda":
        ap.error("--kernel-times needs the card")
    rec = drive(args.sides, args.pairs, args.kernel_times, args.device,
                args.scale)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
