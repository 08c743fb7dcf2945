"""Everything of the benchmark found by name, each in a file of its own.

- ``configs/<name>.json``: a deployment (graph shape and size, index and
  engine settings, the guarantees);
- ``mixes/<name>.json``: a traffic mix (the operations of one step);
- ``workloads/<name>.json``: a cell (a configuration, a mix, the chips);
- ``metrics/<name>.py``: the reader of one metric, ``read(run)``;
- ``BENCHMARK.json`` at the root of the checkout: the cells' metrics.

No code here or elsewhere in the harness names a cell, a mix, a
configuration or a metric: adding one is adding its files.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def use_src(root: Path = ROOT) -> None:
    """Put the checkout's ``src`` on the import path (the program)."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def mix(name: str, base: Path = HERE) -> dict:
    return _json("mixes", name, base)


def workload(name: str, base: Path = HERE) -> dict:
    return _json("workloads", name, base)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def cell_entry(bench: dict, cell: str) -> dict:
    """The cell's entry in ``BENCHMARK.json``'s ``workloads``."""
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")


def check_cell(bench: dict, cell: str, wl: dict) -> None:
    """The cell's file and its ``BENCHMARK.json`` entry name the same
    configuration, mix and chips."""
    e = cell_entry(bench, cell)
    mine = (wl["config"], wl["mix"], int(wl["chips"]))
    theirs = (e["config"], e["traffic"], int(e["chips"]))
    if mine != theirs:
        raise ValueError(f"workloads/{cell}.json says {mine}, "
                         f"BENCHMARK.json says {theirs}")


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: the
    end-to-end metrics without a ``workloads`` key or that list the cell,
    and the per-layer metrics that list it (each must have the key)."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def reader(name: str, base: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod_name = "reachbench.metrics._" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
