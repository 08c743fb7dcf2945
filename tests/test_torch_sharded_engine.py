"""The port's vertex-sharded serving over 4 gloo ranks on the CPU:
``QueryEngine(vertex_mesh=...)``, ``planes.sharded_rows`` /
``sharded_il_rows`` and ``planes.sharded_pruned_bfs``, held bitwise
against the JAX package's replicated ``QueryEngine`` and the port's.

Runs itself as a script in a subprocess on the rank harness of
``tests/test_torch_sharded_planes.py``: every rank serves each case on its
shard and records answers, ``EngineStats``, ``last_rebuild_info`` and the
rebuilt row blocks; meanwhile pytest replays the serving cases on both
packages' replicated engines, then compares them step by step.

The cases twin ``tests/distributed/run_sharded_planes.py``'s
``engine_stream_and_budget`` (in both consistency modes and with word
planes; the jit budget has no analogue: the port has no jit cache), the
dirty query of ``lifecycle_differential``, the packed engine query of
``packed_sharded_parity`` and ``verdict_path_hlo_is_all_gather_free``
(done as a collective audit); ``run_sharded_il.py``'s ``sharded_il_rows``
step and ``engine_stream``; and ``run_plan_extension.py``'s
``rebuild_insert_flush_ordering``.  Beyond them: the sharded residue BFS
against ``pruned_bfs`` (clean, stale cutoffs, dirty), a deadline flush
under skewed rank clocks, the refusals and the serving CLI.
"""
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import distributed as TD
from repro_torch.core import graph as TG
from repro_torch.core import planes as TPL
from repro_torch.core import query as TQ
from repro_torch.graphs.generators import power_law
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer
from repro_torch.serve.reach_server import main as serve_main
from tests.test_torch_sharded_planes import (WORLD, _bits, _np,
                                             clean_batch, finish_world,
                                             script_main, start_world)

K = dict(k=16, k_prime=16, max_iters=64)
FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=7)
ENG = dict(bfs_chunk=64, max_iters=64)
PLANES = ("dl_in", "dl_out", "bl_in", "bl_out", "il_in", "il_out")
CLI = ["--device", "cpu", "--n", "256", "--m", "1400", "--k", "16",
       "--rounds", "4", "--batch", "96"]


# ------------------------------------------------------------- runners
class ServeRun:
    """Serves a case on one package's engine and records it per step:
    replicated (``mesh`` None; ``api`` the package) or vertex-sharded on
    this rank (the port, ``QueryEngine(vertex_mesh=mesh)``)."""

    def __init__(self, mesh, rec, case, api=None):
        self.mesh, self.rec, self.case = mesh, rec, case
        self.api = api or TorchServe

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def put(self, step, field, value):
        self.rec[f"{self.case}|{step}|{field}"] = value

    def put_dict(self, step, field, d):
        """A dict: as JSON text on a rank (the records go through
        ``np.savez``), as it is on a replica."""
        self.put(step, field, np.array(json.dumps(d, sort_keys=True))
                 if self.sharded else d)

    def graph(self, src, dst, n, m_cap):
        return self.api.make_graph(src, dst, n, m_cap)

    def index(self, g, steps=(), **kw):
        """A built index after ``steps``: ("insert", ns, nd, kw),
        ("delete", ds, dd) or ("rebuild", kw).  Sharded: the shard of
        ``distributed``'s lifecycle functions, which the engine takes as
        it is."""
        if self.sharded:
            idx, plan = TD.build_vertex_sharded(g, self.mesh, **kw)
        else:
            idx = self.api.build(g, **kw)
        for op, *a in steps:
            if op == "delete":
                idx = idx.delete_edges(*a)
            elif self.sharded and op == "insert":
                idx, plan, _ = TD.insert_vertex_sharded(idx, plan, a[0],
                                                        a[1], **a[2])
            elif self.sharded:
                idx, plan, _ = TD.rebuild_vertex_sharded(idx, plan, **a[0])
            elif op == "insert":
                idx = idx.insert_edges(a[0], a[1], **a[2])
            else:
                idx = idx.rebuild(**a[0])
        return idx

    def engine(self, idx, **kw):
        if self.sharded:
            kw["vertex_mesh"] = self.mesh
        return self.api.Engine(idx, **kw)

    def query(self, step, eng, u, v):
        self.put(step, "ans", np.asarray(eng.query(u, v)))

    def flush(self, step, eng, pends, **kw):
        for i, a in enumerate(eng.flush(pends, **kw)):
            self.put(step, f"ans{i}", np.asarray(a))

    def rebuild(self, step, eng, **kw):
        idx = eng.rebuild(**kw)
        for f in PLANES:
            if getattr(idx, f) is not None:
                self.put(step, f, _np(getattr(idx, f)))
        self.put_dict(step, "info", eng.last_rebuild_info)

    def stats(self, step, eng):
        self.put_dict(step, "stats", eng.stats.as_dict())

    def skew_clock(self, eng, now):
        """Deadline clocks read ``now``; rank 0's (and a replica's) runs
        at twice the rate, so the ranks disagree on when a deadline
        passes."""
        fast = not self.sharded or self.mesh.rank == 0
        eng._clock = lambda: now[0] * (2.0 if fast else 1.0)


class TorchServe:
    """The port's replicated index and engine on the CPU."""
    Engine = TEngine

    @staticmethod
    def make_graph(src, dst, n, m_cap):
        return TG.make_graph(src, dst, n, m_cap=m_cap, device="cpu")

    @staticmethod
    def build(g, **kw):
        return TIndex.build(g, device="cpu", **kw)


def jax_serve():
    """The JAX package's replicated index and engine (imported here: the
    ranks never import JAX)."""
    from repro.core import DBLIndex as JIndex
    from repro.core import graph as JG
    from repro.serve.engine import QueryEngine as JEngine

    class JaxServe:
        Engine = JEngine

        @staticmethod
        def make_graph(src, dst, n, m_cap):
            return JG.make_graph(src, dst, n, m_cap=m_cap)

        @staticmethod
        def build(g, **kw):
            return JIndex.build(g, **kw)

    return JaxServe


# ------------------------------------------------------- serving cases
def _rand(rng, n, q):
    return (rng.integers(0, n, q).astype(np.int32),
            rng.integers(0, n, q).astype(np.int32))


def _engine_stream(run, consistency, plane_repr="bool"):
    """A mixed submit/insert/delete/flush/rebuild stream (8 rounds, a
    delete at round 4, a flush at round 3), the auto rebuild, a query
    batch and a "latest" flush across an insert."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=9)
    idx = run.index(run.graph(src, dst, n, m + 1024), n_cap=n, **K)
    eng = run.engine(idx, consistency=consistency, plane_repr=plane_repr,
                     **ENG)
    rng = np.random.default_rng(4)
    pend = []
    for r in range(8):
        u, v = _rand(rng, n, 96)
        run.query(f"query{r}", eng, u, v)
        pend.append(eng.submit(eng.index, u, v))
        eng.insert(*_rand(rng, n, 24))
        if r == 4:
            eng.delete(src[:20], dst[:20])
        if r == 3:
            run.flush("flush3", eng, pend)
            pend = []
    run.flush("flush_end", eng, pend)
    run.rebuild("rebuild", eng, mode="auto")
    u, v = _rand(rng, n, 300)
    run.query("after_rebuild", eng, u, v)
    p = eng.submit(eng.index, u, v)
    eng.insert(src[:8], dst[:8])
    run.flush("latest", eng, [p], consistency="latest")
    run.stats("end", eng)


def engine_stream_asof(run):
    _engine_stream(run, "as-of-submit")


def engine_stream_latest(run):
    _engine_stream(run, "latest")


def engine_stream_packed(run):
    """The stream on an engine whose inserts and rebuilds run the OR
    fixpoints on word planes."""
    _engine_stream(run, "as-of-submit", plane_repr="packed")


def engine_stream_il(run):
    """``run_sharded_il.py``'s ``engine_stream``: the interval family
    through 6 rounds (a delete at round 3), one flush, the delta rebuild
    and a query batch."""
    n, m = 256, 1200
    src, dst = power_law(n, m, seed=9)
    idx = run.index(run.graph(src, dst, n, m + 1024), n_cap=n, **K, **FAM)
    eng = run.engine(idx, **ENG)
    rng = np.random.default_rng(4)
    pend = []
    for r in range(6):
        u, v = _rand(rng, n, 96)
        run.query(f"query{r}", eng, u, v)
        pend.append(eng.submit(eng.index, u, v))
        eng.insert(*_rand(rng, n, 24))
        if r == 3:
            eng.delete(src[:20], dst[:20])
    run.flush("flush", eng, pend)
    run.stats("flush", eng)
    run.rebuild("rebuild", eng, mode="delta")
    u, v = _rand(rng, n, 300)
    run.query("after_rebuild", eng, u, v)
    run.stats("end", eng)


def dirty_query(run):
    """``lifecycle_differential``'s dirty query: an engine bound to the
    index after three inserts and a delete (a shard taken as it is)."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=3)
    rng = np.random.default_rng(0)
    steps = [("insert", *_rand(rng, n, 32), dict(max_iters=64))
             for _ in range(3)]
    steps.append(("delete", src[10:60], dst[10:60]))
    idx = run.index(run.graph(src, dst, n, m + 512), steps, n_cap=n, **K)
    assert idx.is_dirty
    eng = run.engine(idx, **ENG)
    run.query("dirty", eng, *_rand(rng, n, 600))
    run.stats("end", eng)


def packed_engine_query(run):
    """``packed_sharded_parity``'s engine query: word-plane build, two
    inserts, a delete and the delta rebuild, then a packed engine."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=6)
    rng = np.random.default_rng(2)
    pr = dict(max_iters=64, plane_repr="packed")
    steps = [("insert", *_rand(rng, n, 32), pr) for _ in range(2)]
    steps += [("delete", src[5:45], dst[5:45]),
              ("rebuild", dict(mode="delta", **pr))]
    idx = run.index(run.graph(src, dst, n, m + 512), steps, n_cap=n,
                    plane_repr="packed", **K)
    eng = run.engine(idx, plane_repr="packed", **ENG)
    run.query("packed", eng, *_rand(rng, n, 300))
    run.stats("end", eng)


def rebuild_insert_flush_ordering(run):
    """submit -> delete -> delta rebuild -> insert -> submit -> flush: the
    insert after the rebuild extends the plan the rebuild handed over,
    with no from-scratch plan; a stale plan handed over is not adopted."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=13)
    idx = run.index(run.graph(src, dst, n, m + 1024), n_cap=n, **K)
    eng = run.engine(idx, **ENG)
    rng = np.random.default_rng(17)
    p1 = eng.submit(eng.index, *_rand(rng, n, 96))
    eng.delete(src[:30], dst[:30])
    eng.rebuild(mode="delta")
    ns, nd = clean_batch(rng, n, 24)
    if run.sharded:
        adopted = eng._plan
        run.put("rebuild", "plan", np.array(
            [eng._plan_override is None, adopted.m == eng.index.graph.m]))
        calls = []
        orig = TPL.shard_plan
        TPL.shard_plan = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
        try:
            eng.insert(ns, nd)
        finally:
            TPL.shard_plan = orig
        run.put("insert", "plan", np.array(
            [len(calls), eng._plan.m - adopted.m, len(ns)]))
    else:
        eng.insert(ns, nd)
    p2 = eng.submit(eng.index, *_rand(rng, n, 96))
    run.flush("flush", eng, [p1, p2])
    if run.sharded:
        eng._plan_override = eng._plan._replace(m=eng._plan.m + 999)
        eng.index = eng.index
        run.put("rebind", "plan", np.array(
            [eng._plan_override is None,
             eng._plan.m == eng.index.graph.m]))
    run.query("after", eng, *_rand(rng, n, 64))
    run.stats("end", eng)


def deadline_flush_skewed(run):
    """``flush_policy="deadline"`` with rank 0's clock running at twice
    the others' rate: the ranks agree on each poll, so all of them flush
    at the poll where rank 0's deadline passed, and none earlier."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=9)
    idx = run.index(run.graph(src, dst, n, m + 256), n_cap=n, **K)
    eng = run.engine(idx, flush_policy="deadline", flush_deadline_ms=5.0,
                     **ENG)
    now = [0.0]
    run.skew_clock(eng, now)
    rng = np.random.default_rng(6)
    pend = [eng.submit(eng.index, *_rand(rng, n, 200))]
    eng.insert(*_rand(rng, n, 16))
    flushed = []
    for t in (0.002, 0.004):
        now[0] = t
        flushed.append(eng.maybe_flush())
    run.put("polls", "flushed", np.array(flushed))
    run.flush("flush", eng, pend)
    run.stats("end", eng)


SERVE_CASES = {f.__name__: f for f in (
    engine_stream_asof, engine_stream_latest, engine_stream_packed,
    engine_stream_il, dirty_query, packed_engine_query,
    rebuild_insert_flush_ordering, deadline_flush_skewed)}


# ------------------------------------------------ rank-only cases
def _rows_index(api=TorchServe):
    """The "il" index the rows and BFS cases share: a build and an insert
    of 64 edges (so edge-count cutoffs below ``m`` are stale)."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=21)
    idx = api.build(api.make_graph(src, dst, n, m + 64), n_cap=n, **K,
                    **FAM)
    ns, nd = clean_batch(np.random.default_rng(22), n, 64)
    return idx.insert_edges(ns, nd, max_iters=64), src, dst


def _bfs_inputs(idx, src, dst):
    """(name, index, u, v, m_cut, dl_clean, frontier dtype) of the BFS
    checks: 64 lanes, the last four dead (``u = n_cap``); fresh,
    stale-cutoff (int8 and int32 frontiers) and dirty (after a delete)."""
    n, m = idx.n_cap, int(np.asarray(idx.graph.m))
    rng = np.random.default_rng(23)
    u, v = _rand(rng, n, 64)
    u[-4:] = n
    fresh = np.full(64, TQ.FRESH_CUT, np.int32)
    stale = rng.choice(np.array([m - 64, m - 20, m, TQ.FRESH_CUT],
                                np.int64), 64).astype(np.int32)
    dirty = idx.delete_edges(src[:60], dst[:60])
    return [("clean", idx, u, v, fresh, True, "int8"),
            ("stale", idx, u, v, stale, True, "int8"),
            ("stale_int32", idx, u, v, stale, True, "int32"),
            ("dirty", dirty, u, v, stale, False, "int8")]


def rows_and_bfs(run):
    """``sharded_rows``/``sharded_il_rows`` (with sentinel lanes) and
    ``sharded_pruned_bfs`` on this rank's shard of a replicated index."""
    mesh = run.mesh
    idx, src, dst = _rows_index()
    shard = TD.place_vertex_sharded(idx, mesh)
    n = idx.n_cap
    rng = np.random.default_rng(24)
    u, v = _rand(rng, n, 100)
    u[:4] = n
    v[2:6] = n
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    for i, b in enumerate(TPL.sharded_rows(shard.packed, ut, vt,
                                           mesh=mesh).__dict__.values()):
        run.put("rows", f"block{i}", _np(b))
    for i, b in enumerate(TPL.sharded_il_rows(shard.il, ut, vt, mesh=mesh)):
        run.put("il_rows", f"block{i}", _np(b))
    for name, ix, u, v, cut, clean, ftype in _bfs_inputs(idx, src, dst):
        sh = TD.place_vertex_sharded(ix, mesh)
        g = sh.graph
        plan = TPL.shard_plan(g.src, g.dst, g.m, n, mesh)
        ut, vt = torch.from_numpy(u), torch.from_numpy(v)
        rows = TPL.sharded_rows(sh.packed, ut.clamp(max=n - 1), vt,
                                mesh=mesh)
        hit = TPL.sharded_pruned_bfs(
            plan, sh.packed, rows, ut, vt, TG.edge_mask(g),
            torch.from_numpy(cut), g.m, clean, max_iters=64,
            frontier_dtype=ftype)
        run.put("bfs", name, _np(hit))


class _Forbidden(AssertionError):
    pass


def collective_audit(run):
    """The serving path's collectives, counted by wrapping
    ``torch.distributed``: an all-gather or broadcast fails the rank;
    the label phase must issue one ``all_reduce`` (two with ``il``) and
    the residue ``all_to_all_single`` exchanges."""
    counts = {"all_reduce": 0, "all_to_all_single": 0}
    saved = {}

    def counting(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call

    def forbidden(name):
        def call(*a, **kw):
            raise _Forbidden(f"{name} on the sharded serving path")
        return call

    wraps = {name: counting(name) for name in counts}
    wraps.update({name: forbidden(name) for name in (
        "all_gather", "all_gather_into_tensor", "all_gather_object",
        "broadcast", "broadcast_object_list", "scatter", "gather")})
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=1)
    out = []
    for fam in ({}, FAM):
        g = TG.make_graph(src, dst, n, m_cap=m + 64, device="cpu")
        idx, _ = TD.build_vertex_sharded(g, run.mesh, n_cap=n, **K, **fam)
        eng = TEngine(idx, vertex_mesh=run.mesh, **ENG)
        u, v = _rand(np.random.default_rng(2), n, 300)
        saved.update({name: getattr(dist, name) for name in wraps})
        try:
            for name, fn in wraps.items():
                setattr(dist, name, fn)
            for name in counts:
                counts[name] = 0
            pend = eng.submit(eng.index, u, v)
            label = dict(counts)
            pend.resolve()
            out.append([label["all_reduce"], label["all_to_all_single"],
                        counts["all_reduce"] - label["all_reduce"],
                        counts["all_to_all_single"], pend.nu])
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
    run.put("audit", "counts", np.array(out))


def cli(run):
    """The serving CLI in this world (``--vertex-shards 4``): rank 0
    prints the stats, the others nothing; a shard count that is not the
    world's is refused."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_main(CLI + ["--vertex-shards", str(WORLD)])
    run.put("cli", "stdout", np.array(buf.getvalue()))
    try:
        serve_main(CLI + ["--vertex-shards", "2"])
        refused = ""
    except ValueError as e:
        refused = str(e)
    run.put("cli", "refused", np.array(refused))


RANK_CASES = {f.__name__: f for f in (rows_and_bfs, collective_audit,
                                      cli)}
CASES = {**SERVE_CASES, **RANK_CASES}


# ----------------------------------------------------------- pytest side
def replay():
    """Each serving case's records on both packages' replicated engines."""
    reps = {}
    for key, api in (("jax", jax_serve()), ("torch", TorchServe)):
        rec = {}
        for name, fn in SERVE_CASES.items():
            fn(ServeRun(None, rec, name, api))
        reps[key] = rec
    return reps


@pytest.fixture(scope="module")
def world():
    proc, out_dir = start_world(Path(__file__), list(CASES))
    try:
        reps = replay()
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return finish_world(proc, out_dir), reps


def _same_on_ranks(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key],
                                      err_msg=f"{key}: ranks disagree")
    return ranks[0][key]


def _keys(rep, case, field=None):
    ks = sorted(k for k in rep if k.startswith(case + "|"))
    assert ks, case
    return [k for k in ks if field is None or k.split("|")[2] == field]


@pytest.mark.parametrize("ref", ["jax", "torch"])
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_answers_bitwise(world, case, ref):
    """Every answer of the stream equals the replicated engine's."""
    ranks, reps = world
    rep = reps[ref]
    keys = [k for k in _keys(rep, case) if k.split("|")[2].startswith("ans")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(_same_on_ranks(ranks, k), rep[k],
                                      err_msg=f"{k} vs {ref}")


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_sharded_rebuilds_bitwise(world, ref):
    """The engines' rebuilt planes (row blocks in rank order) and their
    ``last_rebuild_info``."""
    ranks, reps = world
    rep = reps[ref]
    seen = 0
    for case in SERVE_CASES:
        for k in _keys(rep, case):
            f = k.split("|")[2]
            if f in PLANES:
                got = np.concatenate([r[k] for r in ranks])
                np.testing.assert_array_equal(_bits(got), _bits(rep[k]),
                                              err_msg=f"{k} vs {ref}")
                seen += 1
            elif f == "info":
                assert json.loads(str(_same_on_ranks(ranks, k))) == \
                    rep[k], (k, ref)
    # three bool streams' four planes and the "il" stream's six
    assert seen == 3 * 4 + 6


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_engine_stats_equal(world, case):
    """``EngineStats`` of the sharded engine equal the port's replicated
    engine's, field for field."""
    ranks, reps = world
    rep = reps["torch"]
    keys = _keys(rep, case, "stats")
    assert keys, case
    for k in keys:
        assert json.loads(str(_same_on_ranks(ranks, k))) == rep[k], k


def test_interval_prune_fires_in_the_il_stream(world):
    ranks, _ = world
    hits = json.loads(str(ranks[0]["engine_stream_il|flush|stats"]))
    assert hits["prune_hits"]["il"] > 0


def test_rebuild_hands_its_plan_to_the_insert(world):
    ranks, _ = world
    c = "rebuild_insert_flush_ordering"
    assert _same_on_ranks(ranks, f"{c}|rebuild|plan").all()
    calls, grew, b = _same_on_ranks(ranks, f"{c}|insert|plan")
    assert calls == 0, "the insert after rebuild() planned from scratch"
    assert grew == b, "the insert did not extend the adopted plan"
    assert _same_on_ranks(ranks, f"{c}|rebind|plan").all(), \
        "a plan for another edge prefix was adopted"


def test_deadline_flush_is_agreed_across_skewed_clocks(world):
    ranks, _ = world
    flushed = _same_on_ranks(ranks, "deadline_flush_skewed|polls|flushed")
    # rank 0's deadline passes at the second poll only (8 ms), the
    # others' at neither (4 ms): all ranks flush there together
    assert flushed.tolist() == [False, True]
    stats = json.loads(str(ranks[0]["deadline_flush_skewed|end|stats"]))
    assert stats["policy_flushes"] == 1


def test_sharded_rows_equal_gather_rows(world):
    ranks, _ = world
    idx, _, _ = _rows_index()
    n = idx.n_cap
    rng = np.random.default_rng(24)
    u, v = _rand(rng, n, 100)
    u[:4] = n
    v[2:6] = n
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    want = list(TQ.gather_rows(idx.packed, ut, vt).__dict__.values())
    ids = [u, v, v, u, u, v, v, u]        # the blocks' row ids, in order
    for i, (w, at) in enumerate(zip(want, ids)):
        got = _same_on_ranks(ranks, f"rows_and_bfs|rows|block{i}")
        dead = at == n
        np.testing.assert_array_equal(got[~dead], w.numpy()[~dead])
        assert not got[dead].any(), "sentinel rows must be zero"
    want = TQ.gather_il_rows(idx.il, ut, vt)
    for i, (w, at) in enumerate(zip(want, [u, v, u, v])):
        got = _same_on_ranks(ranks, f"rows_and_bfs|il_rows|block{i}")
        dead = at == n
        np.testing.assert_array_equal(got[~dead], w.numpy()[~dead])
        assert not got[dead].any(), "sentinel interval rows must be zero"


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_sharded_pruned_bfs_equals_pruned_bfs(world, ref):
    ranks, _ = world
    if ref == "jax":
        import jax.numpy as jnp
        from repro.core import query as JQ
        api = jax_serve()
    else:
        api = TorchServe
    for name, idx, u, v, cut, clean, ftype in _bfs_inputs(
            *_rows_index(api)):
        n = idx.n_cap
        if ref == "jax":
            want = JQ.pruned_bfs(idx.graph, idx.packed, jnp.asarray(u),
                                 jnp.asarray(v), None, jnp.asarray(cut),
                                 jnp.asarray(clean), n_cap=n, max_iters=64,
                                 frontier_dtype=ftype)
        else:
            want = TQ.pruned_bfs(idx.graph, idx.packed, torch.from_numpy(u),
                                 torch.from_numpy(v), None,
                                 torch.from_numpy(cut), clean, n_cap=n,
                                 max_iters=64, frontier_dtype=ftype)
        got = _same_on_ranks(ranks, f"rows_and_bfs|bfs|{name}")
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=f"{name} vs {ref}")
        assert not got[-4:].any(), "dead lanes must not hit"


def test_serving_path_issues_no_all_gather(world):
    ranks, _ = world
    counts = _same_on_ranks(ranks, "collective_audit|audit|counts")
    (lab_ar, lab_a2a, bfs_ar, bfs_a2a, nu), \
        (il_ar, il_a2a, _, _, il_nu) = counts.tolist()
    assert (lab_ar, lab_a2a) == (1, 0), "label phase: one all_reduce"
    assert (il_ar, il_a2a) == (2, 0), "label phase with il: two"
    assert nu > 0 and bfs_a2a > 0 and bfs_ar > bfs_a2a


def test_cli_vertex_shards_matches_replicated(world):
    ranks, _ = world
    out = [str(r["cli|cli|stdout"]) for r in ranks]
    assert all(o == "" for o in out[1:]), "only rank 0 prints"
    got = json.loads(out[0])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_main(CLI)
    want = json.loads(buf.getvalue())
    assert got["engine"].pop("layout") == "vertex_sharded"
    assert want["engine"].pop("layout") == "replicated"

    def counters(d):
        """Everything but the host clocks (``wall_s``, the ``*_s``
        times), the device name and the halo telemetry, which only the
        sharded engine's fixpoints feed."""
        d = {k: x for k, x in d.items() if not k.endswith("_s")}
        d["engine"] = {k: x for k, x in d["engine"].items()
                       if k not in ("device", "halo", "halo_bytes",
                                    "halo_rounds", "quiet_pair_rounds")}
        return d
    assert counters(got) == counters(want)
    halo = got["engine"]["halo"]
    assert halo["mode"] == "dense" and halo["halo_rounds"] > 0
    assert got["engine"]["halo_rounds"] == halo["halo_rounds"]
    assert want["engine"]["halo"]["halo_rounds"] == 0
    assert want["engine"]["halo_bytes"] == 0
    assert "4 ranks, not 2" in str(ranks[0]["cli|cli|refused"])


# ------------------------------------------- in-process refusals
def _fake_mesh(rank=0):
    """A mesh handle for code that runs no collective (binding, checks)."""
    return TD.VertexMesh(None, rank, WORLD, torch.device("cpu"))


def _small_index(**kw):
    n, m = 64, 300
    src, dst = power_law(n, m, seed=4)
    g = TG.make_graph(src, dst, n, device="cpu")
    return TIndex.build(g, n_cap=n, device="cpu", **K, **kw)


@pytest.mark.parametrize("kw, err, match", [
    (dict(mesh=object()), ValueError, "mutually exclusive"),
    (dict(frontier_dtype="packed"), ValueError, "per-lane frontier"),
    (dict(streaming=True), ValueError, "streaming=True"),
    (dict(bfs_kernel=True), ValueError, "no kernel is on"),
    (dict(backend="cuda"), ValueError, "no kernel is on"),
])
def test_sharded_engine_refuses(kw, err, match):
    with pytest.raises(err, match=match):
        TEngine(vertex_mesh=_fake_mesh(), **kw)


@pytest.mark.parametrize("backend, device", [
    ("auto", "cpu"), ("torch", "cpu"), ("auto", "cuda")])
def test_sharded_engine_backend_is_torch(backend, device):
    """The sharded path runs torch ops, on a CUDA mesh too: the engine says
    so instead of naming the kernel backend it never launches."""
    mesh = TD.VertexMesh(None, 0, WORLD, torch.device(device))
    eng = TEngine(vertex_mesh=mesh, backend=backend)
    assert eng.backend == "torch" and eng.device == mesh.device
    assert not eng.bfs_kernel and not eng.donate


def test_sharded_engine_binding():
    idx = _small_index()
    # a query mesh serves the replicated index as it is; a mesh of another
    # kind is refused by its type
    qmesh = TD.VertexMesh(None, 0, WORLD, torch.device("cpu"),
                          TD.QUERY_AXIS)
    qeng = TEngine(idx, mesh=qmesh, bfs_chunk=16)
    assert qeng.index is idx and qeng.layout == "replicated"
    with pytest.raises(TypeError, match="query_mesh"):
        TEngine(idx, mesh=object())
    eng = TEngine(idx, vertex_mesh=_fake_mesh(1), bfs_chunk=16)
    assert eng.layout == "vertex_sharded" and not eng.donate
    s = eng.index
    assert s.layout == TPL.vertex_layout(_fake_mesh(1))
    assert eng._plan.m == idx.graph.m and eng._plan.n_cap == idx.n_cap
    for f in PLANES[:4]:
        assert torch.equal(getattr(s, f), getattr(idx, f)[16:32])
    # a shard of the mesh is taken as it is; one of another rank is not
    eng.index = s
    assert eng.index is s
    with pytest.raises(ValueError, match="not this rank's"):
        TEngine(s, vertex_mesh=_fake_mesh(2))
    # a shard needs a sharded engine, at construction and at a re-bind
    with pytest.raises(ValueError, match="vertex_mesh="):
        TEngine(s)
    rep = TEngine(idx)
    assert rep.layout == "replicated"
    with pytest.raises(ValueError, match="vertex_mesh="):
        rep.index = s
    with pytest.raises(ValueError, match="vertex_mesh="):
        rep.submit(s, [0], [1])
    # only the bound index is served, and only its own batches resolved
    with pytest.raises(ValueError, match="only their bound index"):
        eng.submit(idx, [0], [1])
    # a dirty snapshot, so that the batch leaves a residue to resolve
    dirty = idx.delete_edges(idx.graph.src[:20], idx.graph.dst[:20])
    u, v = _rand(np.random.default_rng(3), idx.n_cap, 64)
    foreign = rep.submit(dirty, u, v)
    assert foreign.nu > 0
    with pytest.raises(ValueError, match="resolve only batches"):
        eng.flush([foreign])


def test_sharded_bfs_refuses_packed_frontiers():
    idx = _small_index()
    mesh = _fake_mesh()
    s = TD.place_vertex_sharded(idx, mesh)
    g = s.graph
    plan = TPL.shard_plan(g.src, g.dst, g.m, idx.n_cap, mesh)
    u = torch.zeros(4, dtype=torch.int32)
    rows = TQ.gather_rows(idx.packed, u, u)
    with pytest.raises(ValueError, match="per-lane frontier"):
        TPL.sharded_pruned_bfs(plan, s.packed, rows, u, u, TG.edge_mask(g),
                               u, g.m, True, frontier_dtype="packed")


def test_server_layout_and_meshes():
    idx = _small_index()
    srv = ReachabilityServer(idx, vertex_mesh=_fake_mesh(), bfs_chunk=16)
    assert srv.engine_stats()["layout"] == "vertex_sharded"
    assert srv.index.layout.sharded
    assert srv.engine_stats()["backend"] == "torch"
    assert ReachabilityServer(idx).engine_stats()["layout"] == "replicated"


if __name__ == "__main__":
    script_main(sys.argv[1:], CASES, ServeRun)
