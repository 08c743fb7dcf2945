"""The ``wikitalk-il`` deployment: its file is ``wikitalk``'s with the
interval family added, the index the harness builds from it is the one
the file states, its cell runs correct through ``run_cell``, and the
readers of the ``repro_torch.insert.il`` span read what it holds, and
nothing where a program has no such span."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from reachbench import run as R
from reachbench import spec
from reachbench import trace as T
from reachbench import traffic
from reachbench.gen import chung_lu, graph_args
from reachbench.system import System

from .conftest import run_tiny, tiny

CELL = "wikitalk-il.ingest"
IL_METRICS = ["engine.il_lanes", "insert.il.device_ms", "insert.il.rounds",
              "insert.il.host_reads"]


def test_the_file_is_wikitalks_with_the_interval_family():
    base, cfg = spec.config("wikitalk"), spec.config("wikitalk-il")
    assert cfg["index"] == dict(base["index"], families=["dl", "bl", "il"])
    assert cfg["reduced"] == [] and cfg["name"] == "wikitalk-il"
    for key in set(base) - {"name", "source", "about", "index", "assumed"}:
        assert cfg[key] == base[key], key
    assert set(base["assumed"].items()) <= set(cfg["assumed"].items())
    # the program's defaults, which the harness does not pass
    assert cfg["assumed"]["il_dim"].startswith("4 ")
    assert cfg["assumed"]["il_seed"].startswith("0:")
    entry = {c["name"]: c for c in spec.benchmark()["configs"]}["wikitalk-il"]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


def test_the_harness_builds_what_the_file_states():
    _, cfg, mix = tiny(CELL)
    g = cfg["graph"]
    n, m, held = int(g["n"]), int(g["m"]), int(mix["held_out"])
    src, dst = chung_lu(n, m, held, seed=5, device=torch.device("cpu"),
                        **graph_args(g))
    system = System(cfg, src[:m], dst[:m], m + held, torch.device("cpu"))
    idx = system.index
    assert idx.families == tuple(cfg["index"]["families"])
    assert idx.il_dim == 4 and idx.il_seed == 0
    assert idx.il_in.shape == idx.il_out.shape == (n, 8)
    system.close()


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_correct_at_the_tiny_size(trace):
    res = run_tiny(CELL, trace=trace)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["read_back_lanes"]["value"] >= 1
    names = set(res["metrics"])
    if not trace:
        assert names == {m["name"] for m in spec.metrics_of(
            spec.benchmark(), CELL, "end_to_end")}
        return
    # every counter's and span's metric the cell lists, the shared ones
    # beside the four of the il family; no device time on the CPU
    listed = spec.metrics_of(spec.benchmark(), CELL, "per_layer")
    assert set(IL_METRICS) <= {m["name"] for m in listed}
    assert names == {m["name"] for m in listed
                     if m["source"] in ("program_counter", "program_span")}
    assert res["metrics"]["insert.il.host_reads"]["value"] > 0
    assert (res["metrics"]["insert.il.host_reads"]["value"]
            < res["metrics"]["insert.host_reads"]["value"])


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": {}}


#: two traced insert calls: the DL/BL fixpoint (one round, one read)
#: outside the il span, then the il span with two fixpoints, three rounds
#: and four reads in the first call, one round and two reads in the second
INSERTS = [
    _x("user_annotation", "reachbench.window", 0, 1000),
    _x("user_annotation", "reachbench.insert", 0, 400),
    _x("cpu_op", "repro_torch.insert", 5, 390),
    _x("cpu_op", "repro_torch.insert.fixpoint", 10, 90),
    _x("cpu_op", "repro_torch.insert.round", 20, 20),
    _x("cpu_op", "repro_torch.sync.fixpoint_go", 50, 10),
    _x("kernel", "dlbl", 20, 40),
    _x("cpu_op", "repro_torch.insert.il", 200, 150),
    _x("cpu_op", "repro_torch.insert.fixpoint", 205, 60),
    _x("cpu_op", "repro_torch.insert.round", 210, 10),
    _x("cpu_op", "repro_torch.insert.round", 225, 10),
    _x("cpu_op", "repro_torch.sync.seed_keep", 206, 2),
    _x("cpu_op", "repro_torch.sync.fixpoint_go", 240, 5),
    _x("cpu_op", "repro_torch.insert.fixpoint", 270, 70),
    _x("cpu_op", "repro_torch.insert.round", 280, 10),
    _x("cpu_op", "repro_torch.sync.seed_keep", 271, 2),
    _x("cpu_op", "repro_torch.sync.fixpoint_go", 300, 5),
    _x("kernel", "il_a", 210, 30),
    _x("kernel", "il_b", 280, 20),
    _x("user_annotation", "reachbench.insert", 500, 300),
    _x("cpu_op", "repro_torch.insert", 505, 290),
    _x("cpu_op", "repro_torch.insert.il", 600, 100),
    _x("cpu_op", "repro_torch.insert.fixpoint", 605, 40),
    _x("cpu_op", "repro_torch.insert.round", 610, 10),
    _x("cpu_op", "repro_torch.sync.fixpoint_go", 625, 5),
    _x("cpu_op", "repro_torch.insert.fixpoint", 650, 40),
    _x("cpu_op", "repro_torch.sync.fixpoint_go", 660, 5),
    _x("kernel", "il_a", 610, 10),
    # after the window's inserts: not read
    _x("cpu_op", "repro_torch.insert.il", 900, 50),
    _x("kernel", "il_a", 900, 50),
]


def _run(events, hits=None):
    run = R.Run(config={})
    run.trace = T.reduce({"traceEvents": events})
    run.lat["query"] = [0.001, 0.002]
    run.counters = {"engine": {"prune_hits": hits or {
        "dl": 5, "bl": 7, "il": 30, "thm": 0, "bfs": 4}}}
    return run


def test_the_readers_read_what_the_il_span_holds():
    run = _run(INSERTS)
    read = {m: spec.reader(m)(run) for m in IL_METRICS}
    assert read["engine.il_lanes"] == 15.0
    assert read["insert.il.rounds"] == 2.0             # (3 + 1) / 2 calls
    assert read["insert.il.host_reads"] == 3.0         # (4 + 2) / 2
    assert read["insert.il.device_ms"] == 0.03         # (50 + 10) us / 2
    # the whole insert's counts keep their meaning: every round and read
    assert spec.reader("insert.fixpoint_rounds")(run) == 2.5
    assert spec.reader("insert.host_reads")(run) == 3.5


def test_a_program_without_the_il_span_reads_none_of_it():
    run = _run([e for e in INSERTS if e["name"] != "repro_torch.insert.il"])
    for name in IL_METRICS[1:]:
        assert spec.reader(name)(run) is None, name
    assert spec.reader("insert.fixpoint_rounds")(run) == 2.5
    run.trace = None
    for name in IL_METRICS[1:]:
        assert spec.reader(name)(run) is None, name
    run.lat["query"] = []
    assert spec.reader("engine.il_lanes")(run) is None


def test_the_plane_check_finds_the_served_planes_equal(capsys):
    path = Path(__file__).resolve().parents[2] / "tools" / "il_planes.py"
    mod_spec = importlib.util.spec_from_file_location("il_planes", path)
    tool = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(tool)
    make = traffic.Ledger.of
    assert tool.main(["--tiny", "--seed", "3", "--seconds", "1"]) == 0
    assert traffic.Ledger.of == make
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["planes_equal"] and line["correct"]
    assert [c["at"] for c in line["planes"]] == ["set-up", "window end"]
    assert line["planes"][1]["updates"] > line["planes"][0]["updates"]
