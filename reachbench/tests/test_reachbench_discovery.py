"""Everything is found by name: every cell of ``BENCHMARK.json`` has its
files, every metric its reader, and a cell, a mix, a configuration and a
metric are added by adding files alone."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from reachbench import spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files(cell):
    wl = spec.workload(cell)
    spec.check_cell(BENCH, cell, wl)
    cfg = spec.config(wl["config"])
    assert cfg["name"] == wl["config"]
    assert spec.mix(wl["mix"])["name"] == wl["mix"]
    entry = spec.cell_entry(BENCH, cell)
    conf = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert Path(spec.ROOT, conf["file"]) == \
        spec.HERE / "configs" / f"{wl['config']}.json"


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_metrics_of_a_cell_follow_the_workloads_key():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a",
                            "workloads": ["x", "y"]},
                           {"name": "q", "moves": "b", "workloads": ["x"]},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    names = lambda c, k: [m["name"] for m in spec.metrics_of(bench, c, k)]
    assert names("x", "end_to_end") == ["a", "b"]
    assert names("y", "end_to_end") == ["a"]
    assert names("x", "per_layer") == ["p", "q"]
    assert names("y", "per_layer") == ["p", "r"]


def test_every_per_layer_metric_lists_its_cells():
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_a_cell_file_that_disagrees_is_refused():
    wl = dict(spec.workload("lj.read"), mix="churn")
    with pytest.raises(ValueError):
        spec.check_cell(BENCH, "lj.read", wl)


ADDED = textwrap.dedent('''
    import json, sys, time, torch
    from reachbench import run, spec
    bench = spec.benchmark()
    out = {}
    for trace in (False, True):
        res = run.run_cell("tiny.burst", spec.workload("tiny.burst"), bench,
                           seed=2**31 + 3, seconds=0.5, trace=trace,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter())
        out[str(trace)] = {"correct": res["correct"],
                           "metrics": sorted(res["metrics"])}
    print(json.dumps(out))
''')


def test_a_new_cell_mix_config_and_metric_are_files_only(tmp_path):
    """A copy of the harness gains a configuration, a mix, a cell, an
    end-to-end and a per-layer metric by new files and new entries in
    ``BENCHMARK.json`` alone, and a run of the new cell finds them all."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "reachbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rb = root / "reachbench"
    cfg = spec.config("wikitalk")
    cfg.update(name="tiny")
    cfg["graph"].update(n=300, m=1200, core=2)
    cfg["server"]["rebuild_dead_ratio"] = 0.01
    (rb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (rb / "mixes" / "burst.json").write_text(json.dumps({
        "name": "burst", "step": [
            {"op": "query", "repeat": 2, "size": 50},
            {"op": "delete", "size": 5}, {"op": "insert", "size": 5}],
        "read_your_writes": 2, "held_out": 400, "query_lanes": 1000,
        "warm_steps": 1,
        "check": {"batches": 8, "lanes": 50, "read_back_batches": 4}}))
    (rb / "workloads" / "tiny.burst.json").write_text(json.dumps(
        {"name": "tiny.burst", "config": "tiny", "mix": "burst",
         "chips": 1}))
    (rb / "metrics" / "delete_p95_ms.py").write_text(
        "from reachbench.readers import p95_ms\n\n\n"
        "def read(run):\n    return p95_ms(run.lat['delete'])\n")
    (rb / "metrics" / "test.deletes_per_call.py").write_text(
        "def read(run):\n"
        "    return run.counters['serve']['deletes'] / "
        "len(run.lat['delete'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "reachbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.burst", "config": "tiny",
                               "traffic": "burst", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "delete_p95_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.burst"]})
    bench["per_layer"].append({"name": "test.deletes_per_call",
                               "unit": "edges", "better": "higher",
                               "source": "program_counter", "layer": "t",
                               "moves": "delete_p95_ms",
                               "workloads": ["tiny.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(spec.ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", ADDED], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["False"]["correct"] and out["True"]["correct"]
    assert out["False"]["metrics"] == sorted(
        ["query_qps", "query_p95_ms", "insert_p95_ms", "insert_eps",
         "setup_s", "delete_p95_ms"])
    assert "test.deletes_per_call" in out["True"]["metrics"]
    assert "engine.rho" not in out["True"]["metrics"]
