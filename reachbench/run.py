"""Run one cell of the benchmark once.

    python3 -m reachbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``workloads/<cell>.json``) names a configuration
(``configs/``), a traffic mix (``mixes/``) and its chips.  Set-up makes
the graph and the held-out edges on the card from the seed
(``gen.chung_lu``), builds the port's DBL index and server over them
(``system.System``), warms the engine's shapes and runs the mix's warm
steps.  The window then repeats the mix's step through the server, one
client in a closed loop, for ``--seconds`` seconds, the card synchronised
at the end of every call.  Once it has closed, the peak memory is read,
the program's state freed, and a sample of the answered batches compared
with the plain reference (``check``).  ``--trace 1`` profiles the window
(``trace``) and reports the per-layer metrics instead of the end-to-end
ones.  Every metric is read by its own reader (``metrics/<name>.py``),
the cell's metrics named by ``BENCHMARK.json``.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the same numbers are the last lines of standard error.  Without a
card, or with fewer cards than the cell asks for, or if JAX or the JAX
package was loaded, it prints no result and exits with another code
than 0.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback
import warnings
from dataclasses import dataclass, field

from reachbench import spec

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = spec.ROOT / "build" / "reachbench"


def set_cache_env() -> None:
    """Point every compile cache a library might use inside the checkout,
    at fixed paths (the port's own kernels build under ``build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def foreign_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def log(*a) -> None:
    print("reachbench:", *a, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a metric reader reads: the run's own clocks and counts, the
    program's counters over the window, and the trace."""
    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    lat: dict = field(default_factory=lambda: {"query": [], "insert": [],
                                               "delete": []})
    done: dict = field(default_factory=lambda: {"query": 0, "insert": 0,
                                                "delete": 0})
    counters: dict = field(default_factory=dict)
    trace: object = None


@dataclass
class Loop:
    """The client's calls attempted and failed, and why the window
    closed."""
    attempted: int = 0
    failed: int = 0
    ended: str = ""


def _delta(after, before):
    if isinstance(after, dict):
        return {k: _delta(v, before.get(k, 0)) for k, v in after.items()}
    if isinstance(after, (int, float)) and not isinstance(after, bool):
        return after - before
    return after


def drive(system, ops, ledger, uniform, loop: Loop, run: Run | None, *,
          read_back, sync, dgen, deadline=None, steps=None, answered=None,
          ranges=False) -> None:
    """Repeat the step through the server until ``deadline`` (a
    ``perf_counter`` time) or for ``steps`` steps.  With ``run``, records
    each call's latency and count; with ``answered``, each query batch's
    lanes, answers and the updates it observed."""
    import numpy as np

    from reachbench.check import Answered
    mark = contextlib.nullcontext
    if ranges:
        from torch.profiler import record_function
        mark = record_function
    done_steps = 0
    while steps is None or done_steps < steps:
        for kind, size in ops:
            if deadline is not None and time.perf_counter() >= deadline:
                loop.ended = "time"
                return
            if kind == "query":
                ru, rv = ledger.read_back(read_back)
                if ru.size > size:
                    raise ValueError(f"{ru.size} lanes read back in a "
                                     f"batch of {size}")
                where = uniform.take(size - ru.size)
                pu, pv = uniform.get(where, size - ru.size)
                args = (np.concatenate([ru, pu]), np.concatenate([rv, pv]))
            elif kind == "insert":
                args = ledger.take_inserts(size)
                if args is None:
                    loop.ended = "held-out edges used up"
                    return
            else:
                args = ledger.take_deletes(size, dgen)
            t_seen = ledger.t
            loop.attempted += 1
            try:
                with mark("reachbench." + kind):
                    t0 = time.perf_counter()
                    out = getattr(system, kind)(*args)
                    sync()
                    dt = time.perf_counter() - t0
            except Exception:
                loop.failed += 1
                loop.ended = "error"
                traceback.print_exc(file=sys.stderr)
                return
            if kind == "query" and answered is not None:
                answered.append(Answered(t_seen, size, ru, rv, where,
                                         _packed(out, size)))
            if run is not None:
                run.lat[kind].append(dt)
                run.done[kind] += size
        done_steps += 1


def _packed(answers, size: int):
    import numpy as np
    a = np.asarray(answers, dtype=bool).reshape(-1)
    if a.size != size:
        raise ValueError(f"{a.size} answers to {size} queries")
    return np.packbits(a)


def run_cell(cell: str, wl: dict, bench: dict, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, cfg: dict | None = None,
             mix: dict | None = None, system_factory=None) -> dict:
    """One run of ``cell``; returns the result's fields (``checks`` and
    the e2e or per-layer metrics).  ``cfg``/``mix``/``system_factory``
    replace the cell's files and the port (the tests' small sizes and
    planted faults)."""
    import torch

    from reachbench import check as C
    from reachbench import trace as T
    from reachbench.gen import chung_lu, graph_args
    from reachbench.system import System
    from reachbench.traffic import Ledger, Pairs, delete_generator, step_ops

    cfg = cfg or spec.config(wl["config"])
    mix = mix or spec.mix(wl["mix"])
    system_factory = system_factory or System
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    phases = {}
    t_phase = [t_start]

    def phase(name, wait=True):
        if wait:
            sync()
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    phase("start", wait=False)          # the interpreter's imports
    if cuda:
        torch.zeros(1, device=device)   # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    phase("device")
    g = cfg["graph"]
    n, m, held = int(g["n"]), int(g["m"]), int(mix["held_out"])
    src, dst = chung_lu(n, m, held, seed=seed, device=device,
                        **graph_args(g))
    ledger = Ledger.of(src, dst, m)
    uniform = Pairs(seed, n, int(mix["query_lanes"]), device)
    phase("generate")
    system = system_factory(cfg, src[:m], dst[:m], m + held, device)
    phase("build")
    ops = step_ops(mix)
    system.warmup(sorted({s for k, s in ops if k == "query"}))
    phase("warmup")
    loop = Loop()
    dgen = delete_generator(seed, device)
    kw = dict(read_back=int(mix.get("read_your_writes", 0)), sync=sync,
              dgen=dgen)
    drive(system, ops, ledger, uniform, loop, None,
          steps=int(mix["warm_steps"]), **kw)
    if loop.failed:
        raise RuntimeError("a warm step failed")
    t_window = ledger.t
    phase("warm_steps")
    run = Run(cfg)
    run.setup_s = time.perf_counter() - t_start
    log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in phases.items()))
    before = system.counters()
    answered = []
    loop = Loop()
    prof = {}
    with (T.profiled(prof) if trace else contextlib.nullcontext()):
        with (torch.profiler.record_function("reachbench.window") if trace
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            drive(system, ops, ledger, uniform, loop, run,
                  deadline=t0 + seconds, answered=answered, ranges=trace,
                  **kw)
            run.window_s = time.perf_counter() - t0
    run.trace = prof.get("trace")
    if "reading_s" in prof:
        log("trace reading (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in prof["reading_s"].items()))
    log(f"set-up {run.setup_s:.3f} s; window and trace reading "
        f"{time.perf_counter() - t0:.3f} s")
    run.counters = _delta(system.counters(), before)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window {run.window_s:.3f} s, closed by {loop.ended}; "
        f"calls attempted {loop.attempted}, failed {loop.failed}; "
        f"held-out edges used {ledger.inserted} of {held}; uniform lanes "
        f"{len(uniform.chunks)} chunks, {mix['query_lanes']} drawn in "
        f"set-up")
    t = time.perf_counter()
    cmp = C.compare(seed, answered, ledger, uniform, n, mix["check"],
                    device)
    log(f"reference over {cmp['lanes_checked']} lanes "
        f"({cmp['read_back_lanes']} read back) of "
        f"{cmp['batches_checked']} batches took "
        f"{time.perf_counter() - t:.3f} s")
    for kind in ("query", "insert", "delete"):
        lat = sorted(run.lat[kind])
        if lat:
            log(f"{kind}: {len(lat)} calls, {run.done[kind]} items, "
                f"p50 {1e3 * lat[len(lat) // 2]:.3f} ms, "
                f"max {1e3 * lat[-1]:.3f} ms")
    log("counters over the window: " + json.dumps(run.counters))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for mdef in spec.metrics_of(bench, cell, kind):
        value = spec.reader(mdef["name"])(run)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
    back = 1 if kw["read_back"] and any(a.read_u.size
                                        for a in answered) else 0
    checks = {
        "mismatches": {"value": cmp["mismatches"], "limit": 0},
        "failed_calls": {"value": loop.failed, "limit": 0},
        "lanes_checked": {"value": cmp["lanes_checked"], "at_least": 1},
        "read_back_lanes": {"value": cmp["read_back_lanes"],
                            "at_least": back},
    }
    correct = (cmp["mismatches"] == 0 and loop.failed == 0
               and cmp["lanes_checked"] >= 1
               and cmp["read_back_lanes"] >= back)
    out = {"correct": correct, "attempted": loop.attempted,
           "failed": loop.failed, "metrics": metrics,
           "peak": peak, "t_window": t_window, "checks": checks,
           "compare": cmp, "ledger": ledger, "answered": answered,
           "uniform": uniform, "phases": phases}
    if trace and run.trace is not None:
        tr = run.trace
        w0, w1 = tr.window()
        out["busy_s"] = tr.busy_us([(w0, w1)]) / 1e6
        out["traced_s"] = (w1 - w0) / 1e6
        out["breakdown"] = {"device_ops": T.top_device_ops(tr, [(w0, w1)]),
                            "idle_gaps": T.idle_gaps(tr)}
    return out


def result_line(res: dict, device_info: dict) -> dict:
    """The result's last line, ``checks`` last."""
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device_info}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    set_cache_env()
    warnings.filterwarnings("ignore", message="index_reduce")
    import torch
    wl = spec.workload(a.workload)
    bench = spec.benchmark()
    spec.check_cell(bench, a.workload, wl)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(wl["chips"]):
        log(f"{a.workload} needs {wl['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    dev = torch.device("cuda", 0)
    res = run_cell(a.workload, wl, bench, seed=a.seed, seconds=a.seconds,
                   trace=bool(a.trace), device=dev, t_start=t_start)
    found = foreign_modules()
    if found:
        log("JAX or the JAX package was loaded: " + ", ".join(found))
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(wl["chips"]), "memory_peak_bytes": int(res["peak"])}
    if a.trace:
        if "busy_s" not in res:
            log("the profiler gave no trace")
            return 5
        info.update(busy_s=res["busy_s"], window_s=res["traced_s"])
    for name, c in res["checks"].items():
        lim = (f"limit {c['limit']}" if "limit" in c
               else f"at least {c['at_least']}")
        log(f"check {name} {c['value']} {lim}")
    print(json.dumps(result_line(res, info)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
