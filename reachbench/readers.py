"""Arithmetic the metric readers (``metrics/<name>.py``) share: the tail
of a latency list, device time and idle share inside the harness's
ranges, and a kernel's share of its roofline."""
from __future__ import annotations

import re

import numpy as np

from reachbench import bounds


def p95_ms(lat) -> float | None:
    """The 95th percentile of the latencies (seconds) in ms, linear
    between order statistics; None without a sample."""
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None


def rate(run, kind: str) -> float | None:
    """Items of ``kind`` completed a second over the whole window."""
    done = run.done[kind]
    return done / run.window_s if done and run.window_s > 0 else None


def _spans(run, kind: str) -> list:
    """The ``kind`` ranges of a trace that saw the card; none otherwise
    (a run without device activity reads no device metric)."""
    if run.trace is None or not run.trace.device:
        return []
    return run.trace.range_spans(kind)


def range_device_ms(run, kind: str) -> float | None:
    """Device-busy ms inside the ``kind`` ranges, per range (per call)."""
    spans = _spans(run, kind)
    if not spans:
        return None
    return run.trace.busy_us(spans) / 1e3 / len(spans)


def range_idle_share(run, kind: str) -> float | None:
    """100 x (1 - device busy / wall) inside the ``kind`` ranges."""
    spans = _spans(run, kind)
    wall = sum(b - a for a, b in spans)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us(spans) / wall)


def _dims(shapes, i):
    d = shapes[i] if shapes and i < len(shapes) else []
    return list(d) if isinstance(d, (list, tuple)) else []


def roofline(run, op: str, kernel: str, launch_bound) -> float | None:
    """100 x (summed bound of the ``op`` calls) / (summed device time of
    the kernels named ``kernel``), over the traced window.  ``launch_bound``
    maps one call's operand shapes to its bound in seconds.  None where no
    such kernel ran."""
    if run.trace is None:
        return None
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel) + r"\b")
    k_s = sum(t1 - t0 for name, t0, t1 in run.trace.device
              if pat.search(name)) / 1e6
    calls = [s for name, _, _, s in run.trace.ops if name == op]
    if k_s <= 0 or not calls:
        return None
    return 100.0 * sum(launch_bound(s) for s in calls) / k_s


def verdicts_bound(run):
    """The bound of one ``repro_torch::dbl_query_verdicts`` call from its
    operand shapes (dl_in, dl_out, bl_in, bl_out, u, v, cut, ...)."""
    out_bytes = 1 if run.config["engine"]["out_dtype"] == "int8" else 4

    def bound(shapes):
        n_cap, wd = _dims(shapes, 0)
        wb = _dims(shapes, 2)[1]
        q = _dims(shapes, 4)[0]
        cut = _dims(shapes, 6)
        ncut = cut[0] if len(cut) == 2 else 0
        return bounds.bound_s(*bounds.verdicts(n_cap, wd, wb, q, ncut,
                                               out_bytes))
    return bound


def admit_bound(shapes) -> float:
    """The bound of one ``repro_torch::bfs_admit_plane`` call from its
    operand shapes (bl_in, bl_out, dl_in, dl_out, u, v, fresh)."""
    n_cap, wb = _dims(shapes, 0)
    wd = _dims(shapes, 2)[1]
    q = _dims(shapes, 4)[0]
    fresh = len(_dims(shapes, 6)) == 1
    return bounds.bound_s(*bounds.admit(n_cap, wd, wb, q, fresh))
