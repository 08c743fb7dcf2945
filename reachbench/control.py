"""The control of the comparison, on the card at a cell's own size.

    python3 -m reachbench.control --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

For each seed, one run of the cell as the benchmark runs it, then the
sampled batches compared with the reference: the program's answers
(``mismatches``, the lower reading: 0 on a sound run) and each
control's (``check``: the reference with the search cut at 2, 4 or 8
rounds, or with the updates deferred past the window or by one), whose
least is the upper reading.  All seeds in one process.  One JSON line a
seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time

from reachbench import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    run.set_cache_env()
    import torch

    from reachbench import check
    if not torch.cuda.is_available():
        run.log("the control runs on a CUDA card")
        return 3
    wl = spec.workload(a.workload)
    bench = spec.benchmark()
    dev = torch.device("cuda", 0)
    mix = spec.mix(wl["mix"])
    for seed in a.seeds:
        t = time.perf_counter()
        res = run.run_cell(a.workload, wl, bench, seed=seed,
                           seconds=a.seconds, trace=False, device=dev,
                           t_start=t)
        cmp = check.compare(seed, res["answered"], res["ledger"],
                            res["uniform"],
                            int(spec.config(wl["config"])["graph"]["n"]),
                            mix["check"], dev, t_window=res["t_window"])
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": res["correct"],
                          "updates_in_window": res["ledger"].t
                          - res["t_window"], **cmp}), flush=True)
        del res
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
