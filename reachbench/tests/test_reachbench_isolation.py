"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (``repro_torch`` is the program); the reference
imports nothing of the program; nothing reads the JAX package's
benchmarks."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from reachbench import run, spec

SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & set(run.FORBIDDEN)
    text = path.read_text()
    if path.parent.name != "tests":
        assert "BENCH_PR" not in text and "benchmarks/" not in text


def test_reference_imports_nothing_of_the_program():
    mods = set(_imports(spec.HERE / "reference.py"))
    assert mods <= {"__future__", "torch"}


def test_foreign_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.foreign_modules() == ["repro.core"]


RUN_ALL = """
import json, time, torch, sys
from tests_conftest import run_tiny
for cell in ("lj.read", "wikitalk.ingest", "wikitalk.churn"):
    for trace in (False, True):
        assert run_tiny(cell, trace=trace, seconds=0.3)["correct"]
from reachbench import run
print(json.dumps(run.foreign_modules()))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    (tmp_path / "tests_conftest.py").write_text(
        (spec.HERE / "tests" / "conftest.py").read_text())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(spec.ROOT), str(spec.ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", RUN_ALL], env=env,
                          cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
