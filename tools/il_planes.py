"""The served index's interval planes against their plain reference, on
the graph a timed run of the benchmark left.

    python3 tools/il_planes.py --workload wikitalk-il.ingest --seed <n>
        --seconds 30 [--out build/il_planes.json]

runs the cell once through the harness (``reachbench.run.run_cell``, the
same set-up, warm steps, window and ``correct`` as ``reachbench.run``)
and, at the end of set-up and again when the window has closed, compares
the index's ``il_in``/``il_out`` bit for bit with
``reachbench.il_reference.by_fixpoint`` over the benchmark's own live
edges at that moment (its ``Ledger``) and the index's seed ranks.  It
also checks that the index's live edges are the ledger's, as a multiset.
The comparisons run outside the window.  ``--tiny`` runs the cell at the
tests' CPU size instead (no card needed).  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from reachbench import spec  # noqa: E402

spec.use_src()


def _keys(src, dst, n):
    return torch.sort(src.long() * n + dst.long()).values


def compare(system, ledger, at: str) -> dict:
    """One comparison of the served index with the reference."""
    from repro_torch.core import graph as G
    from repro_torch.core.interval import rank_plane

    from reachbench.il_reference import by_fixpoint
    t0 = time.perf_counter()
    idx = system.server.index
    n = idx.n_cap
    live = ledger.live_at(ledger.t)
    src, dst = ledger.src[live], ledger.dst[live]
    g = idx.graph
    mask = G.edge_mask(g)
    same_edges = torch.equal(_keys(src, dst, n),
                             _keys(g.src[mask], g.dst[mask], n))
    seed = rank_plane(n, idx.il_dim, idx.il_seed, src.device)
    ref_in, ref_out = by_fixpoint(src, dst, seed)
    out = {"at": at, "updates": ledger.t, "live_edges": int(src.numel()),
           "same_edges": same_edges,
           "il_in_equal": torch.equal(ref_in, idx.il_in),
           "il_out_equal": torch.equal(ref_out, idx.il_out),
           "rows_differ": int(((ref_in != idx.il_in).any(1)
                               | (ref_out != idx.il_out).any(1)).sum())}
    if src.is_cuda:
        torch.cuda.synchronize(src.device)
    out["seconds"] = time.perf_counter() - t0
    print("il_planes:", json.dumps(out), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="wikitalk-il.ingest")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    from reachbench import run as R
    from reachbench import traffic
    from reachbench.system import System
    R.set_cache_env()
    ledgers = []
    make = traffic.Ledger.of

    def keep(*args, **kw):
        ledgers.append(make(*args, **kw))
        return ledgers[-1]
    found = []

    class Checked(System):
        # the harness reads the counters once as the window opens and once
        # as it closes, both outside the window
        def counters(self):
            found.append(compare(self, ledgers[-1],
                                 "set-up" if not found else "window end"))
            return super().counters()

    bench = spec.benchmark()
    kw = {}
    if a.tiny:
        from reachbench.tests.conftest import tiny
        wl, kw["cfg"], kw["mix"] = tiny(a.workload)
        dev = torch.device("cpu")
    else:
        wl = spec.workload(a.workload)
        if not torch.cuda.is_available():
            R.log("needs a CUDA card (or --tiny)")
            return 3
        dev = torch.device("cuda", 0)
    traffic.Ledger.of = keep
    try:
        res = R.run_cell(a.workload, wl, bench, seed=a.seed,
                         seconds=a.seconds, trace=False, device=dev,
                         t_start=t_start, system_factory=Checked, **kw)
    finally:
        traffic.Ledger.of = make
    ok = len(found) == 2 and all(
        c["same_edges"] and c["il_in_equal"] and c["il_out_equal"]
        for c in found)
    line = {"planes_equal": ok, "correct": res["correct"],
            "checks": res["checks"], "planes": found,
            "metrics": res["metrics"],
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", "memory_peak_bytes": int(res["peak"])}
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return 0 if ok and res["correct"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
