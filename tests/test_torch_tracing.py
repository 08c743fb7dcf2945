"""The serving path's spans (``repro_torch.tracing``): with no profiler
recording, a span is one shared null context and no range is opened;
under a profiler, the spans are operator ranges in its trace, they nest
as the engine's phases do, the round spans count the rounds the fixpoint
and BFS loops run, and answers and the index stay bitwise what they are
unprofiled."""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import profile

from repro_torch import tracing
from repro_torch.core import graph as G
from repro_torch.core import update as U
from repro_torch.core.dbl import DBLIndex
from repro_torch.core.graph import make_graph
from repro_torch.graphs.generators import power_law
from repro_torch.kernels.bfs_relax import bfs_relax
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.reach_server import ReachabilityServer

N, M = 300, 1100

#: (index options, engine options) of each served layout
CASES = {
    "bool": ({}, {}),
    "packed": (dict(plane_repr="packed"),
               dict(plane_repr="packed", frontier_dtype="packed")),
    "il": (dict(families=("dl", "bl", "il"), il_dim=2), {}),
}

#: the span a span opens inside (None: outside any span), as the serving
#: path nests them
PARENT = {
    "repro_torch.query": {None},
    "repro_torch.query.label": {"repro_torch.query"},
    "repro_torch.sync.query_input": {"repro_torch.query.label"},
    "repro_torch.query.residue": {"repro_torch.query", "repro_torch.delete"},
    "repro_torch.sync.n_unknown": {"repro_torch.query.residue"},
    "repro_torch.sync.residue_lanes": {"repro_torch.query.residue"},
    "repro_torch.sync.residue_input": {"repro_torch.query.residue"},
    "repro_torch.query.residue.chunk": {"repro_torch.query.residue"},
    "repro_torch.sync.bfs_go": {"repro_torch.query.residue.chunk"},
    "repro_torch.query.residue.round": {"repro_torch.query.residue.chunk"},
    "repro_torch.sync.bfs_edges": {"repro_torch.query.residue.round"},
    "repro_torch.sync.hits": {"repro_torch.query.residue"},
    "repro_torch.sync.answers": {"repro_torch.query.residue"},
    "repro_torch.sync.order": {"repro_torch.query.residue"},
    "repro_torch.sync.counts": {"repro_torch.query.residue"},
    "repro_torch.insert": {None},
    "repro_torch.sync.insert_input": {"repro_torch.insert"},
    "repro_torch.sync.insert_keep": {"repro_torch.insert"},
    "repro_torch.insert.il": {"repro_torch.insert"},
    "repro_torch.insert.fixpoint": {"repro_torch.insert",
                                    "repro_torch.insert.il"},
    "repro_torch.sync.seed_keep": {"repro_torch.insert.fixpoint"},
    "repro_torch.sync.segment_keep": {"repro_torch.insert.fixpoint"},
    "repro_torch.sync.fixpoint_go": {"repro_torch.insert.fixpoint"},
    "repro_torch.insert.round": {"repro_torch.insert.fixpoint"},
    "repro_torch.sync.fixpoint_edges": {"repro_torch.insert.round"},
    "repro_torch.sync.segment_runs": {"repro_torch.insert.fixpoint",
                                      "repro_torch.insert.round"},
    "repro_torch.delete": {None},
    "repro_torch.sync.delete_input": {"repro_torch.delete"},
    "repro_torch.sync.delete_match": {"repro_torch.delete"},
    "repro_torch.sync.dead_edges": {None},
}


class Recorder:
    """Stands in for the profiler's range: records each span with the span
    open around it."""

    def __init__(self):
        self.open, self.spans = [], []

    @contextlib.contextmanager
    def __call__(self, name):
        self.spans.append((name, self.open[-1] if self.open else None))
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()

    def count(self, name):
        return sum(s == name for s, _ in self.spans)


@pytest.fixture
def recorder(monkeypatch):
    """Spans on, as under a profiler, each recorded by a ``Recorder``."""
    rec = Recorder()
    monkeypatch.setattr(tracing, "_range", rec)
    monkeypatch.setattr(tracing, "_recording", lambda: True)
    yield rec


def _index(case, max_iters=256):
    src, dst = power_law(N, M, seed=3)
    g = make_graph(src, dst, N, m_cap=M + 200, device="cpu")
    return DBLIndex.build(g, n_cap=N, k=16, k_prime=16, max_iters=max_iters,
                          device="cpu", **CASES[case][0])


def _serve(case, idx=None):
    """A stream through the server over ``idx`` (or a new index):
    queries, an insert, queries, a delete, queries on the dirty labels.
    Returns (answers, index, engine stats)."""
    eng = QueryEngine(idx or _index(case), bfs_chunk=16, bfs_kernel=True,
                      device="cpu", **CASES[case][1])
    # the tombstone ratio is read after each delete; 1.0 is never reached
    srv = ReachabilityServer(None, engine=eng, rebuild_dead_ratio=1.0)
    rng = np.random.default_rng(7)
    out = []

    def query():
        out.append(srv.query(rng.integers(0, N, 200),
                             rng.integers(0, N, 200)))
    query()
    src, dst = rng.integers(0, N, 40), rng.integers(0, N, 40)
    srv.insert(src, dst)
    query()
    srv.delete(src[:10], dst[:10])
    query()
    return out, srv.index, srv.engine_stats()


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not tracing.enabled()
    off = tracing.span("repro_torch.query.label")
    assert isinstance(off, contextlib.nullcontext)
    assert tracing.span("repro_torch.insert") is off
    with profile():
        assert tracing.enabled()
        assert tracing.span("repro_torch.insert") is not off
    assert not tracing.enabled()
    assert tracing.span("repro_torch.insert") is off


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "on"])
def test_spans_record_only_under_a_profiler(profiled, monkeypatch,
                                            tmp_path):
    if not profiled:
        # no profiler: not one range is opened
        rec = Recorder()
        monkeypatch.setattr(tracing, "_range", rec)
        _serve("bool")
        assert rec.spans == []
        return
    with profile() as prof:
        _serve("bool")
    names = {e.name for e in prof.events()
             if e.name.startswith("repro_torch.")}
    assert {"repro_torch.query.label", "repro_torch.query.residue",
            "repro_torch.insert", "repro_torch.delete",
            "repro_torch.sync.bfs_go"} <= names
    # the Chrome trace files them as operators, beside the aten ones
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "") in names}
    assert cats == {"cpu_op"}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_as_the_phases_do(case, recorder):
    idx = _index(case)
    recorder.spans.clear()          # the build's fixpoints
    _serve(case, idx)
    assert recorder.spans
    for name, parent in recorder.spans:
        assert name in PARENT, name
        assert parent in PARENT[name], (name, parent)
        # a sync span encloses the read alone
        assert parent is None or not parent.startswith("repro_torch.sync.")
    # on the CPU a BFS round's read (the plain relax's) lies inside the
    # exported round: its sync span is the round's one child
    assert recorder.count("repro_torch.sync.bfs_edges") == \
        recorder.count("repro_torch.query.residue.round")
    seen = {name for name, _ in recorder.spans}
    # the packed fixpoints scan word runs where the bool ones drop
    # out-of-range ids
    never = {"repro_torch.sync.seed_keep", "repro_torch.sync.segment_keep"} \
        if case == "packed" else {"repro_torch.sync.segment_runs"}
    if case != "il":
        never.add("repro_torch.insert.il")
    assert seen == set(PARENT) - never


@pytest.mark.parametrize("plane_repr", ["bool", "packed"])
@pytest.mark.parametrize("max_iters", [1, 256], ids=["cut", "converged"])
def test_insert_round_spans_count_the_fixpoint_rounds(plane_repr, max_iters,
                                                      recorder):
    idx = _index("bool", max_iters=max_iters)
    recorder.spans.clear()
    g2 = idx.graph
    rng = np.random.default_rng(11)
    ns = torch.from_numpy(rng.integers(0, N, 40).astype(np.int32))
    nd = torch.from_numpy(rng.integers(0, N, 40).astype(np.int32))
    g2 = G.insert_edges(g2, ns, nd)
    _, iters = U.update_inserted(
        g2, (idx.dl_in, idx.dl_out, idx.bl_in, idx.bl_out), ns, nd,
        n_cap=N, max_iters=max_iters, plane_repr=plane_repr)
    # a cut fixpoint ran max_iters rounds and reports max_iters + 1
    assert U.saturated(iters, max_iters) == (max_iters == 1)
    assert recorder.count("repro_torch.insert.round") == \
        sum(min(i, max_iters) for i in iters)
    assert recorder.count("repro_torch.insert.fixpoint") == 4


class Stacks(Recorder):
    """A ``Recorder`` that keeps every span open around each span."""

    @contextlib.contextmanager
    def __call__(self, name):
        self.spans.append((name, tuple(self.open)))
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()

    def inside(self, name, outer):
        return sum(s == name and outer in o for s, o in self.spans)


@pytest.mark.parametrize("case", ["bool", "il"])
def test_the_il_span_holds_the_interval_fixpoints(case, monkeypatch):
    """One ``repro_torch.insert.il`` an insert on an "il" index, none on a
    DL/BL one; the interval hook's two fixpoint spans and all their
    rounds nest inside it, the four DL/BL fixpoints outside it."""
    rec = Stacks()
    monkeypatch.setattr(tracing, "_range", rec)
    monkeypatch.setattr(tracing, "_recording", lambda: True)
    eng = QueryEngine(_index(case), bfs_chunk=16, bfs_kernel=True,
                      device="cpu")
    rng = np.random.default_rng(13)
    total = 0
    for _ in range(3):
        ns = rng.integers(0, N, 30).astype(np.int32)
        nd = rng.integers(0, N, 30).astype(np.int32)
        rounds = 0
        if case == "il":
            # the same hook outside the engine: its rounds
            idx = eng.index
            g2 = G.insert_edges(idx.graph, torch.from_numpy(ns),
                                torch.from_numpy(nd))
            _, _, it = U.insert_update_plugin(
                "il", g2, idx.il_in, idx.il_out, torch.from_numpy(ns),
                torch.from_numpy(nd), n_cap=N, max_iters=eng.max_iters)
            rounds = sum(min(i, eng.max_iters) for i in it)
        rec.spans.clear()
        eng.insert(ns, nd)
        il = "repro_torch.insert.il"
        assert rec.count(il) == (case == "il")
        assert all(o == ("repro_torch.insert",)
                   for s, o in rec.spans if s == il)
        assert rec.inside("repro_torch.insert.fixpoint", il) == \
            (2 if case == "il" else 0)
        assert rec.count("repro_torch.insert.fixpoint") == \
            4 + rec.inside("repro_torch.insert.fixpoint", il)
        assert rec.inside("repro_torch.insert.round", il) == rounds
        assert all("repro_torch.insert.fixpoint" in o for s, o in rec.spans
                   if s == "repro_torch.insert.round")
        total += rounds
    assert (total > 0) == (case == "il")


@pytest.mark.parametrize("frontier_dtype", ["int8", "packed"])
def test_bfs_round_spans_count_the_loop_rounds(frontier_dtype, recorder):
    idx = _index("bool")
    eng = QueryEngine(idx, bfs_chunk=16, bfs_kernel=True, device="cpu",
                      frontier_dtype=frontier_dtype)
    recorder.spans.clear()
    live = eng.coalesced_round
    rounds = []

    def counted(carry, consts):
        rounds.append(1)
        return live(carry, consts)
    eng.coalesced_round = counted
    rng = np.random.default_rng(5)
    eng.query(rng.integers(0, N, 300), rng.integers(0, N, 300))
    assert len(rounds) > 0
    assert recorder.count("repro_torch.query.residue.round") == len(rounds)
    assert recorder.count("repro_torch.sync.bfs_go") >= \
        recorder.count("repro_torch.query.residue.chunk")


@pytest.mark.parametrize("waits", [True, False], ids=["plain", "kernel"])
def test_the_round_opens_its_sync_span_where_the_relax_waits(
        waits, recorder, monkeypatch):
    """``sync.bfs_edges`` opens inside a round exactly where the relax
    step waits on the host (``bfs_relax.waits_on_host`` of the operands'
    device: the plain relax on the CPU, not the kernel on the card); the
    rounds are counted either way."""
    asked = []

    def rule(device):
        asked.append(torch.device(device).type)
        return waits
    monkeypatch.setattr(engine_mod, "waits_on_host", rule)
    _serve("bool")
    rounds = recorder.count("repro_torch.query.residue.round")
    assert rounds > 0 and set(asked) == {"cpu"}
    assert recorder.count("repro_torch.sync.bfs_edges") == \
        (rounds if waits else 0)
    assert bfs_relax.waits_on_host("cpu") and \
        not bfs_relax.waits_on_host("cuda")


@pytest.mark.parametrize("case", list(CASES))
def test_tracing_leaves_answers_and_index_bitwise(case):
    off = _serve(case)
    with profile():
        on = _serve(case)
    for a, b in zip(off[0], on[0]):
        np.testing.assert_array_equal(a, b)
    i0, i1 = off[1], on[1]
    for name in ("dl_in", "dl_out", "bl_in", "bl_out", "il_in", "il_out"):
        p0, p1 = getattr(i0, name), getattr(i1, name)
        assert (p0 is None) == (p1 is None), name
        if p0 is not None:
            assert torch.equal(p0, p1), name
    for name in ("src", "dst", "del_at"):
        assert torch.equal(getattr(i0.graph, name), getattr(i1.graph, name))
    assert (i0.graph.m, i0.graph.del_epoch, i0.epoch) == \
        (i1.graph.m, i1.graph.del_epoch, i1.epoch)
    assert off[2] == on[2]
