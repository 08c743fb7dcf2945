"""The program's spans in the traced run (``reachbench.spans``): the trace
files them among the host's operators, a query phase is charged the work
it launched up to the read that waits for it, idle gaps are named by the
innermost span, and the new readers read spans where the program records
them and nothing where it does not."""
from __future__ import annotations

import pytest

from reachbench import run as R
from reachbench import spans as S
from reachbench import spec, trace as T

from .conftest import run_tiny

COUNTS = ["engine.bfs_rounds", "insert.fixpoint_rounds", "query.host_reads",
          "insert.host_reads"]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


#: a traced query call of a program without spans: the window, a query
#: range, host operators, a custom op, a kernel and a copy
BEFORE = [
    _x("user_annotation", "reachbench.window", 0, 1000),
    _x("user_annotation", "reachbench.query", 100, 400),
    _x("cpu_op", "aten::nonzero", 150, 50),
    _x("cpu_op", "repro_torch::dbl_query_verdicts", 120, 10,
       **{"Input Dims": [[8, 2], [8], [8]]}),
    _x("kernel", "verdicts_kernel", 140, 20),
    _x("kernel", "relax_kernel", 260, 20),
    _x("gpu_memcpy", "Memcpy DtoH", 300, 10),
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
]

#: what the program's spans add: operator ranges.  The label span
#: (110-150) launches the verdict kernel, which runs 140-160, after the
#: span; the residue's first read (205-230) waits for it
ADDED = [
    _x("cpu_op", "repro_torch.query", 105, 390),
    _x("cpu_op", "repro_torch.query.label", 110, 40),
    _x("cpu_op", "repro_torch.query.residue", 200, 250),
    _x("cpu_op", "repro_torch.sync.n_unknown", 205, 25),
    _x("cpu_op", "repro_torch.query.residue.round", 240, 30),
    _x("cpu_op", "repro_torch.sync.answers", 295, 30),
]


def _run(events):
    run = R.Run(config={})
    run.trace = T.reduce({"traceEvents": events})
    run.lat["query"] = [0.001]
    return run


def test_spans_are_filed_among_the_host_operators():
    old = T.reduce({"traceEvents": BEFORE})
    new = T.reduce({"traceEvents": BEFORE + ADDED})
    for tr in (old, new):
        assert tr.device == [("verdicts_kernel", 140.0, 160.0),
                             ("relax_kernel", 260.0, 280.0),
                             ("Memcpy DtoH", 300.0, 310.0)]
        assert tr.ranges == {"reachbench.window": [(0.0, 1000.0)],
                             "reachbench.query": [(100.0, 500.0)]}
        assert tr.ops == [("repro_torch::dbl_query_verdicts", 120.0, 130.0,
                           [[8, 2], [8], [8]])]
    assert S.program_spans(old, "repro_torch.") == []
    assert S.program_spans(new, "repro_torch.query.label") == [(110.0,
                                                                150.0)]
    assert len(S.program_spans(new, "repro_torch.sync.")) == 2
    assert len(S.program_spans(new, "repro_torch.query.residue.")) == 1
    calls = new.range_spans("query")
    assert S.inside(S.program_spans(new, "repro_torch."), calls) == \
        S.program_spans(new, "repro_torch.")
    assert S.inside(S.program_spans(new, "repro_torch."),
                    [(600.0, 700.0)]) == []
    with pytest.raises(ValueError):
        S.program_spans(new, "aten::nonzero")


def test_a_phase_is_charged_the_work_it_launched():
    """The verdict kernel runs after the label span has ended, before the
    read that waits for it ends: the label's.  The round's kernel and the
    answers' copy run after that read: the residue's."""
    run = _run(BEFORE + ADDED)
    tr = run.trace
    assert S.phase_intervals(tr, tr.range_spans("query")) == {
        "label": [(110.0, 230.0)], "residue": [(230.0, 450.0)]}
    assert tr.busy_us(S.program_spans(tr, "repro_torch.query.label")) == \
        10.0                                # the host interval's share
    assert spec.reader("query.label.device_ms")(run) == 0.02
    assert spec.reader("query.residue.device_ms")(run) == 0.03
    # the two add up to the query call's device time
    assert spec.reader("query.device_ms")(run) == 0.05


def test_idle_gaps_are_named_by_the_innermost_span():
    tr = T.reduce({"traceEvents": BEFORE + ADDED})
    gaps = dict(map(tuple, T.idle_gaps(tr)))
    # 160-260: its middle (210) inside the read, no operator there
    assert gaps["repro_torch.sync.n_unknown"] == pytest.approx(100e-6)
    # 280-300: its middle in the residue span, after the round
    assert gaps["repro_torch.query.residue"] == pytest.approx(20e-6)
    # inside the call: 100-140 in the label span, 310-500 in the residue
    assert S.idle_by_span(tr, tr.range_spans("query")) == {
        "repro_torch.query.label": pytest.approx(40e-6),
        "repro_torch.sync.n_unknown": pytest.approx(100e-6),
        "repro_torch.query.residue": pytest.approx(210e-6)}
    # an operator inside a span names the gap in the breakdown
    ev = [_x("user_annotation", "reachbench.window", 0, 100),
          _x("user_annotation", "reachbench.query", 0, 100),
          _x("kernel", "k", 0, 10), _x("kernel", "k", 90, 10),
          _x("cpu_op", "repro_torch.query.residue", 20, 60),
          _x("cpu_op", "repro_torch.sync.answers", 40, 20),
          _x("cpu_op", "aten::_local_scalar_dense", 45, 10)]
    tr = T.reduce({"traceEvents": ev})
    assert T.idle_gaps(tr) == [["aten::_local_scalar_dense",
                                pytest.approx(80e-6)]]
    assert S.idle_by_span(tr, tr.range_spans("query")) == {
        "repro_torch.sync.answers": pytest.approx(80e-6)}
    # a stretch with no span open and no work on the card
    assert S.idle_by_span(tr, [(200.0, 300.0)]) == {
        None: pytest.approx(100e-6)}


def test_summary_of_the_query_calls():
    tr = T.reduce({"traceEvents": BEFORE + ADDED})
    s = S.summary(tr, "query")
    assert s["calls"] == 1 and s["spans_a_call"] == 6
    assert s["by_name_a_call"]["repro_torch.sync.n_unknown"] == 1
    assert s["phase_device_ms_a_call"] == {"label": 0.02, "residue": 0.03}
    assert s["idle_named_share"] == 1.0
    assert S.summary(tr, "insert") == {}


def test_a_program_without_spans_reads_none_of_them():
    run = _run(BEFORE)
    for name in COUNTS + ["query.label.device_ms",
                          "query.residue.device_ms"]:
        assert spec.reader(name)(run) is None, name
    run = _run(BEFORE + ADDED)
    assert spec.reader("query.host_reads")(run) == 2.0
    assert spec.reader("engine.bfs_rounds")(run) == 1.0
    assert spec.reader("insert.host_reads")(run) is None
    assert spec.reader("insert.fixpoint_rounds")(run) is None
    run.trace = None
    assert spec.reader("query.host_reads")(run) is None


@pytest.mark.parametrize("cell", ["lj.read", "wikitalk.churn"])
def test_tiny_traced_run_reports_the_span_counts(cell):
    res = run_tiny(cell, trace=True)
    assert res["correct"]
    for name in COUNTS:
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] >= 0
    assert res["metrics"]["query.host_reads"]["value"] > 0
    assert res["metrics"]["insert.host_reads"]["value"] > 0
    # no device activity on the CPU: no device time to split
    assert "query.label.device_ms" not in res["metrics"]
    assert "query.residue.device_ms" not in res["metrics"]
