"""What the program's ``repro_torch.insert.il`` span holds in a traced
run: the interval family's update inside an insert call (its two MIN
fixpoints, their rounds and their host reads).  The DL/BL update before
it ends in a host read, and so does the il update, so the span's host
interval holds the device work the il update launched.  A program without
the span, or a run without the family, reads None."""
from __future__ import annotations

from reachbench import spans as S

IL = S.PROGRAM + "insert.il"


def il_spans(run) -> tuple[int, list]:
    """(the traced insert calls, the il spans inside them)."""
    tr = run.trace
    calls = tr.range_spans("insert") if tr is not None else []
    if not calls:
        return 0, []
    return len(calls), S.inside(S.program_spans(tr, IL), calls)


def count_in_il(run, pattern: str) -> float | None:
    """The program's ``pattern`` spans inside the il spans, an insert
    call."""
    calls, il = il_spans(run)
    if not il:
        return None
    return len(S.inside(S.program_spans(run.trace, pattern), il)) / calls


def il_device_ms(run) -> float | None:
    """Device-busy ms inside the il spans, an insert call; None without
    device activity."""
    calls, il = il_spans(run)
    if not il or not run.trace.device:
        return None
    return run.trace.busy_us(il) / 1e3 / calls
