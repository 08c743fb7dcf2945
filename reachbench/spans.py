"""The program's spans in a traced run, read from the harness's ``Trace``.

The port records its spans (``repro_torch.tracing``) while the profiler
records, as operator ranges: ``trace.reduce`` keeps them in
``Trace.host`` beside the ``aten::`` operators, named ``repro_torch.``
and a dot (the port's custom operators are ``repro_torch::``).  So an
idle gap inside a span is named by the innermost of them in the
breakdown.  A program without spans leaves none there, and each reader
here then reads None.

A span's launches are asynchronous: a kernel launched inside the label
span often runs after the span has ended, so device time inside the
span's host interval would charge it to the wrong phase.  But a read of
the device waits for everything launched before it.  The label phase's
outputs are first read by ``repro_torch.sync.n_unknown``, the residue's
first read, and the residue launches nothing before it.  So a query's
label phase takes the device time from the label span's start to the end
of that read, and its residue the device time from there to the end of
the residue span, whose last reads wait for all it launched.  That is
the device time launched inside each span, for one batch a call, as
every cell makes.

    python3 -m reachbench.spans --workload <cell> --seed <n> --seconds <s>

runs ``reachbench.run`` with ``--trace 1`` and logs, to standard error,
what the spans say of each kind of call (``summary``); the result line
stays the last line of standard output.
"""
from __future__ import annotations

import bisect
import json
import sys
import time

from reachbench import trace as T

PROGRAM = "repro_torch."
#: the residue's first read, which waits for all the label phase launched
LABEL_READ = PROGRAM + "sync.n_unknown"


def _named(name: str, pattern: str) -> bool:
    """Whether ``name`` is the span ``pattern`` (every span under it for a
    ``pattern`` that ends in a dot)."""
    return name == pattern or (pattern.endswith(".")
                               and name.startswith(pattern))


#: the last trace, its program spans [(t0, t1, name), ...] and the union
#: of its device intervals: the readers of one run make each once
_last = (None, [], [])


def _of(tr) -> tuple:
    global _last
    if _last[0] is not tr:
        _last = (tr, [(a, b, name) for name, a, b in tr.host
                      if name.startswith(PROGRAM)],
                 T.union([(a, b) for _, a, b in tr.device]))
    return _last


def _program(tr) -> list:
    return _of(tr)[1]


def _busy_us(tr, spans) -> float:
    """``Trace.busy_us`` on the union made once."""
    return sum(b - a for a, b in T.clip(_of(tr)[2], spans))


def program_spans(tr, pattern: str) -> list:
    """The (t0, t1) of the program's spans named ``pattern``, by start."""
    if not pattern.startswith(PROGRAM):
        raise ValueError(f"not a program span: {pattern!r}")
    return [(a, b) for a, b, name in _program(tr) if _named(name, pattern)]


def inside(spans, outer) -> list:
    """The ``spans`` ((t0, t1, ...) tuples) that start inside the (t0, t1)
    ``outer`` ones."""
    out = T.union(outer)
    starts = [a for a, _ in out]
    keep = []
    for sp in spans:
        i = bisect.bisect_right(starts, sp[0]) - 1
        if i >= 0 and sp[0] <= out[i][1]:
            keep.append(sp)
    return keep


def _calls(run, kind: str) -> list:
    """The harness's ``kind`` calls that the program traced: [] where it
    recorded no ``repro_torch.<kind>`` span in them."""
    tr = run.trace
    calls = tr.range_spans(kind) if tr is not None else []
    if calls and inside(program_spans(tr, PROGRAM + kind), calls):
        return calls
    return []


def span_count(run, kind: str, pattern: str) -> float | None:
    """The program's ``pattern`` spans in the ``kind`` calls, a call,
    device activity or not; None where the program traced no such call."""
    calls = _calls(run, kind)
    if not calls:
        return None
    return len(inside(program_spans(run.trace, pattern), calls)) / len(calls)


def phase_intervals(tr, calls) -> dict:
    """{"label": [...], "residue": [...]}: the stretches of the card's
    clock that hold the work each query phase launched in ``calls``."""
    reads = inside(program_spans(tr, LABEL_READ), calls)
    read_starts = [a for a, _ in reads]
    out = {"label": [], "residue": []}
    for a, b in inside(program_spans(tr, PROGRAM + "query.label"), calls):
        # the first read after the label span waits for all it launched
        i = bisect.bisect_left(read_starts, b)
        out["label"].append((a, reads[i][1] if i < len(reads) else b))
    for a, b in inside(program_spans(tr, PROGRAM + "query.residue"), calls):
        i = bisect.bisect_left(read_starts, a)
        cut = reads[i][1] if i < len(reads) and reads[i][0] <= b else a
        out["residue"].append((cut, b))
    return out


def phase_device_ms(run, phase: str) -> float | None:
    """Device ms a query call launched in its ``phase`` ("label" or
    "residue"); None without device activity or without such spans."""
    calls = _calls(run, "query")
    if not calls or not run.trace.device:
        return None
    spans = phase_intervals(run.trace, calls)[phase]
    if not spans:
        return None
    return _busy_us(run.trace, spans) / 1e3 / len(calls)


def idle_by_span(tr, calls) -> dict:
    """{innermost program span at each gap's middle (None where none was
    open): idle seconds} over the card's idle gaps whose middle lies
    inside ``calls``."""
    out = T.union(calls)
    starts = [a for a, _ in out]
    busy = T.clip(_of(tr)[2], out)
    gaps, k = [], 0
    for a, b in out:
        t = a
        while k < len(busy) and busy[k][0] < b:
            if busy[k][0] > t:
                gaps.append((t, busy[k][0]))
            t = max(t, busy[k][1])
            k += 1
        if b > t:
            gaps.append((t, b))
    prog = _program(tr)
    by, stack, j = {}, [], 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid > out[i][1]:
            continue
        # spans nest on one thread: the stack holds those open at mid
        while j < len(prog) and prog[j][0] <= mid:
            while stack and stack[-1][1] < prog[j][0]:
                stack.pop()
            stack.append(prog[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = stack[-1][2] if stack else None
        by[inner] = by.get(inner, 0.0) + (b - a) / 1e6
    return by


def summary(tr, kind: str) -> dict:
    """What the spans say of the ``kind`` calls: calls, spans a call by
    name, busy ms a call, device ms a query call by phase, idle seconds
    by innermost span (``-`` where none was open) and the share of the
    idle time a span names."""
    calls = tr.range_spans(kind)
    if not calls:
        return {}
    n = len(calls)
    names = {}
    for _, _, name in inside(_program(tr), calls):
        names[name] = names.get(name, 0) + 1
    idle = idle_by_span(tr, calls)
    total = sum(idle.values())
    out = {"calls": n,
           "spans_a_call": sum(names.values()) / n,
           "by_name_a_call": {k: v / n for k, v in sorted(names.items())},
           "busy_ms_a_call": _busy_us(tr, calls) / 1e3 / n}
    if kind == "query" and tr.device:
        out["phase_device_ms_a_call"] = {
            k: _busy_us(tr, v) / 1e3 / n
            for k, v in phase_intervals(tr, calls).items()}
    out["idle_s_by_span"] = {k or "-": v for k, v in sorted(
        idle.items(), key=lambda kv: -kv[1])}
    out["idle_named_share"] = ((total - idle.get(None, 0.0)) / total
                               if total else None)
    return out


def main(argv=None) -> int:
    from reachbench import run as R
    kept = {}
    reduce = T.reduce

    def keep(chrome):
        kept["trace"] = reduce(chrome)
        return kept["trace"]
    T.reduce = keep
    try:
        rc = R.main(list(argv if argv is not None else sys.argv[1:])
                    + ["--trace", "1"])
    finally:
        T.reduce = reduce
    tr = kept.get("trace")
    if tr is not None:
        t0 = time.perf_counter()
        for kind in ("query", "insert", "delete"):
            s = summary(tr, kind)
            if s:
                R.log(f"program spans in {kind} calls: " + json.dumps(s))
        R.log(f"span summaries took {time.perf_counter() - t0:.3f} s")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
