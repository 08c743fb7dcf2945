"""Run some phases of ``chip_smoke.py`` alone on the card: build the kernel
libraries, then each named phase, in the order given.

    python tools/chip_phases.py kernel_times aot warmup

Phases: ``kernel_times`` (``chip_smoke.kernel_timings``: device, host and
plain times a launch of each kernel at the main paths' shapes, each held
bitwise against its plain version), ``relax`` (``chip_smoke.relax_timings``:
the relax kernel held bitwise on every round of real residue BFS runs at
the benchmark's wiki-Talk and LiveJournal shapes, and timed), and the phases that take the device
and the card's line: ``main``, ``dynamic``, ``il_packed``, ``baselines``,
``aot``, ``warmup``, ``gnn``, ``mind``, ``lm``, ``train``.  Each phase
prints its own JSON lines, as in the whole script, and then one line
with the launch counts it returned.  Prints the card's name and power
limit first; exits 2 without a card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    phases = {"main": cs.main_path, "dynamic": cs.dynamic_phase,
              "il_packed": cs.il_packed_phase,
              "baselines": cs.baselines_phase, "aot": cs.aot_phase,
              "warmup": cs.warmup_phase, "gnn": cs.gnn_phase,
              "mind": cs.mind_phase, "lm": cs.lm_phase,
              "train": cs.train_phase}
    names = sys.argv[1:] if argv is None else argv
    unknown = [n for n in names
               if n not in ("kernel_times", "relax") and n not in phases]
    if not names or unknown:
        print(f"give phases among kernel_times, relax, {', '.join(phases)}"
              + (f"; unknown: {unknown}" if unknown else ""),
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    t = time.perf_counter()
    _build.build(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        _build.load(name)
    cs.emit("build", seconds=time.perf_counter() - t)
    for name in names:
        if name == "kernel_times":
            cs.emit("kernel_times", card=card, **cs.kernel_timings(dev))
        elif name == "relax":
            cs.emit("relax_times", card=card, **cs.relax_timings(dev, card))
        else:
            cs.emit(f"{name}_launches", launches=phases[name](dev, card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
