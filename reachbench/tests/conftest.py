"""Shared pieces of the benchmark's tests.  ``chip`` marks the tests that
need a card; each decides inside the test whether one is there."""
from __future__ import annotations

import copy
import json
import time

from reachbench import spec

spec.use_src()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


#: a graph and mixes small enough for the CPU, in the cells' shapes
TINY_GRAPH = {"n": 400, "m": 1600}


def tiny(cell: str, seconds: float = 1.0):
    """(workload, config, mix) of ``cell`` cut to a CPU's size: the graph
    to ``TINY_GRAPH`` (its shared core in proportion), every batch to a
    hundredth (at least 8), the read-back lanes to a sixteenth (at least
    2 an update), every batch of the sample checked whole."""
    wl = spec.workload(cell)
    cfg = copy.deepcopy(spec.config(wl["config"]))
    g = cfg["graph"]
    g["core"] = round(g.get("core", 0) * TINY_GRAPH["n"] / g["n"])
    g.update(TINY_GRAPH)
    mix = copy.deepcopy(spec.mix(wl["mix"]))
    for op in mix["step"]:
        op["size"] = max(8, op["size"] // 100)
    mix["held_out"] = 20 * max(op["size"] for op in mix["step"])
    mix["read_your_writes"] = max(2, mix["read_your_writes"] // 16)
    mix["query_lanes"] = 1
    mix["check"] = {"batches": 64, "lanes": 1 << 20, "read_back_batches": 64}
    return wl, cfg, mix


def run_tiny(cell: str, *, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: bool = False, system_factory=None, bench=None):
    """One run of ``cell`` at the tiny size on the CPU."""
    import torch

    from reachbench import run
    wl, cfg, mix = tiny(cell)
    return run.run_cell(cell, wl, bench or spec.benchmark(), seed=seed,
                        seconds=seconds, trace=trace,
                        device=torch.device("cpu"),
                        t_start=time.perf_counter(), cfg=cfg, mix=mix,
                        system_factory=system_factory)


def as_json(x):
    return json.loads(json.dumps(x))
