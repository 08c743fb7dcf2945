"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the metric readers read.

The harness marks every server call with a ``record_function`` range
(``reachbench.query``, ``reachbench.insert``, ``reachbench.delete``) and
the whole window with ``reachbench.window``; the profiler records CPU and
CUDA activity with the operands' shapes.  The Chrome trace it exports (to
the run's temporary directory, deleted after reading) gives:

- ``device``: every kernel, copy and fill on the card, as (name, start,
  end) in microseconds;
- ``ranges``: the harness's ranges by name, as (start, end);
- ``ops``: every ``repro_torch::`` operator call with its operands'
  shapes, as (name, start, end, shapes);
- ``host``: every CPU operator, as (name, start, end), for naming what the
  host did while the card sat idle.

Busy time is the union of the device intervals, so that overlapping work
is counted once.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

PREFIX = "reachbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: how far back from a gap the search for the host op around it looks
_HOST_LOOKBACK = 4096


@dataclass
class Trace:
    device: list = field(default_factory=list)    # (name, t0, t1)
    ranges: dict = field(default_factory=dict)    # name -> [(t0, t1)]
    ops: list = field(default_factory=list)       # (name, t0, t1, shapes)
    host: list = field(default_factory=list)      # (name, t0, t1)

    def window(self) -> tuple[float, float]:
        (w,) = self.ranges[PREFIX + "window"]
        return w

    def busy_us(self, spans) -> float:
        """Device-busy microseconds inside the (t0, t1) ``spans``."""
        return sum(b - a for a, b in clip(union(
            [(t0, t1) for _, t0, t1 in self.device]), spans))

    def range_spans(self, kind: str) -> list:
        return self.ranges.get(PREFIX + kind, [])


def union(intervals) -> list:
    """The union of (t0, t1) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(disjoint, spans) -> list:
    """The parts of the sorted disjoint intervals inside the ``spans``."""
    starts = [a for a, _ in disjoint]
    out = []
    for s0, s1 in sorted(spans):
        i = max(bisect.bisect_right(starts, s0) - 1, 0)
        while i < len(disjoint) and disjoint[i][0] < s1:
            a, b = max(disjoint[i][0], s0), min(disjoint[i][1], s1)
            if b > a:
                out.append((a, b))
            i += 1
    return out


@contextmanager
def profiled(out: dict):
    """Profile the block; ``out["trace"]`` is its ``Trace`` afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=True) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="reachbench-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        t1 = time.perf_counter()
        with open(path) as f:
            chrome = json.load(f)
        t2 = time.perf_counter()
        out["trace"] = reduce(chrome)
        del chrome
        out["reading_s"] = {"export": t1 - t0, "parse": t2 - t1,
                            "reduce": time.perf_counter() - t2}
    finally:
        os.unlink(path)


def reduce(chrome: dict) -> Trace:
    """A ``Trace`` from a Chrome trace's events."""
    tr = Trace()
    for e in chrome.get("traceEvents", chrome) if isinstance(
            chrome, dict) else chrome:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            tr.device.append((name, t0, t1))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            tr.ranges.setdefault(name, []).append((t0, t1))
        elif cat == "cpu_op":
            tr.host.append((name, t0, t1))
            if name.startswith("repro_torch::"):
                shapes = e.get("args", {}).get("Input Dims")
                tr.ops.append((name, t0, t1, shapes))
    tr.device.sort(key=lambda x: x[1])
    tr.host.sort(key=lambda x: x[1])
    return tr


def top_device_ops(tr: Trace, spans, top: int = 10) -> list:
    """[[kernel name, seconds], ...]: the device operations that took most
    time inside the spans."""
    by = {}
    for name, t0, t1 in tr.device:
        for a, b in clip([(t0, t1)], spans):
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[k[:160], v] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds], ...]: the card's idle time
    inside the window, summed by the innermost host operator running at
    the middle of each gap (``python`` where none was: the client's and
    the program's Python, with the harness's range named)."""
    w0, w1 = tr.window()
    busy = clip(union([(a, b) for _, a, b in tr.device]), [(w0, w1)])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    starts = [h[1] for h in tr.host]
    spans = sorted((a, b, name) for name, sp in tr.ranges.items()
                   for a, b in sp if name != PREFIX + "window")
    span_starts = [s[0] for s in spans]
    by = {}
    for a, b in gaps:
        mid = (a + b) / 2
        what = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _HOST_LOOKBACK, -1), -1):
            if tr.host[j][2] >= mid:
                what = tr.host[j][0]
                break
        if what is None:
            k = bisect.bisect_right(span_starts, mid) - 1
            inside = k >= 0 and spans[k][1] >= mid
            what = "python in " + (spans[k][2][len(PREFIX):] if inside
                                   else "client")
        by[what] = by.get(what, 0.0) + (b - a) / 1e6
    return [[k[:160], v] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:top]]
