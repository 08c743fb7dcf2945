"""On the card (``chip``): one short run of each cell through the command
line is correct, and its control is not.  Each test skips without a
card; run them on the card with
``python3 -m pytest -q -m chip reachbench/tests/test_reachbench_chip.py``
(the card's machine has no networkx, which the other files import)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from reachbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    _card()
    proc = subprocess.run(
        [sys.executable, "-m", "reachbench.run", "--workload", cell,
         "--seed", str(2**31 + 17), "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    _card()
    proc = subprocess.run(
        [sys.executable, "-m", "reachbench.control", "--workload", cell,
         "--seconds", "5", "--seeds", str(2**31 + 19)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mismatches"] == 0 and out["read_back_lanes"] > 0
    for control in ("depth4", "frozen", "lag1"):
        assert out[f"control_{control}_mismatches"] > 0, control
