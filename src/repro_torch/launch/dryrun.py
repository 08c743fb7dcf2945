"""Multi-pod dry run: every cell's per-device memory under its layouts.

For every (architecture x input-shape) cell and both production meshes
(16x16 single-pod, 2x16x16 multi-pod, abstract: no process is started),
build the cell's shape trees and layouts and record the bytes each rank
would hold: ``memory.argument_bytes`` is the sum over every argument leaf
of its local shape's bytes under its layout.  Nothing is compiled, so the
reference's compiled ``temp_bytes``, ``cost`` and ``hlo`` have no
counterpart here and are not recorded; ``peak_bytes_per_device`` is the
argument bytes, held against one NVIDIA H100 80GB's capacity
(``mesh.CHIP_HBM_BYTES``).  ``--save-hlo DIR`` is accepted for the
reference's command line and writes nothing: there is no HLO.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--out out/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

NO_COUNTERPART = ("temp_bytes, output_bytes, alias_bytes, cost and hlo "
                  "come from a compiled executable; the dry run compiles "
                  "nothing")


def run_cell(arch: str, shape: str, mesh_kind: str,
             save_hlo: str | None = None) -> dict:
    """One cell's record.  ``save_hlo`` is the reference's HLO directory:
    nothing is compiled, so nothing is written there."""
    from repro_torch.launch.cells import (SkipCell, build_cell, cell_leaves,
                                          leaf_bytes)
    from repro_torch.launch.mesh import CHIP_HBM_BYTES, make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    record = {"arch": arch, "shape": shape, "mesh": mesh_kind,
              "n_devices": mesh.size}
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape, mesh)
    except SkipCell as e:
        record.update(status="skipped", reason=str(e))
        return record
    record["build_s"] = time.perf_counter() - t0
    arg_bytes = sum(leaf_bytes(x, lay) for _, x, lay in cell_leaves(cell))
    record["memory"] = {
        "argument_bytes": arg_bytes,
        "peak_bytes_per_device": arg_bytes,
        "device_bytes": CHIP_HBM_BYTES,
        "fits": arg_bytes <= CHIP_HBM_BYTES,
        "no_counterpart": NO_COUNTERPART,
    }
    record["meta"] = cell.meta
    record["status"] = "ok"
    return record


def _write(out_dir: str, rec: dict) -> str:
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    # accepted for the reference's command line: with nothing to compile,
    # every cell runs in this process, one after another
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="out/dryrun")
    ap.add_argument("--save-hlo", default=None, metavar="DIR",
                    help="accepted for the reference's command line; the "
                    "dry run compiles nothing, so no HLO is written")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        rec = run_cell(args.arch, args.shape, args.mesh, args.save_hlo)
        print(f"[{rec['status']}] -> {_write(args.out, rec)}")
        return 0

    from repro_torch.launch.cells import all_cells
    counts = {"ok": 0, "skipped": 0}
    for arch, shape in all_cells():
        for mesh_kind in ("pod", "multipod"):
            rec = run_cell(arch, shape, mesh_kind, args.save_hlo)
            _write(args.out, rec)
            counts[rec["status"]] += 1
            peak = rec.get("memory", {}).get("peak_bytes_per_device")
            print(f"[{rec['status']}] {arch} x {shape} x {mesh_kind}"
                  + (f" {peak / 2**30:.3f} GiB/device" if peak else ""),
                  flush=True)
    print(f"{counts['ok']} ok, {counts['skipped']} skipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
