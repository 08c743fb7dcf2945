"""The result's last line: exactly the contract's keys, ``checks`` last;
no result and another exit code than 0 without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from reachbench import run, spec

from .conftest import as_json, run_tiny

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 1}


def test_untraced_line_has_the_contracts_keys():
    res = run_tiny("wikitalk.churn")
    line = as_json(run.result_line(res, DEVICE))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    assert set(line["metrics"]) == {m["name"] for m in spec.metrics_of(
        spec.benchmark(), "wikitalk.churn", "end_to_end")}
    assert all(("limit" in c or "at_least" in c) and "value" in c
               for c in line["checks"].values())


def test_traced_line_has_a_breakdown_before_the_checks():
    res = run_tiny("lj.read", trace=True)
    info = dict(DEVICE, busy_s=res["busy_s"], window_s=res["traced_s"])
    line = as_json(run.result_line(res, info))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # the counters' metrics; the device's are not read from a CPU run
    assert "engine.rho" in line["metrics"]
    assert "query.device_ms" not in line["metrics"]


def _cli(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "reachbench.run", "--workload", "lj.read",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _cli(spec.ROOT, env)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "reachbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _cli(tmp_path, env)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
