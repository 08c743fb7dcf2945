"""The port's query-axis mesh over 4 gloo ranks on the CPU:
``distributed.query_mesh``, ``distributed_label_verdicts`` and
``QueryEngine``/``ReachabilityServer(mesh=...)``, held bitwise against the
JAX package's replicated engine and the port's.

Every rank holds the whole replicated index; a batch's label phase runs
the verdict kernel's op wrapper (its plain version on the CPU) on the
rank's block of the lanes and all-gathers the verdicts; the residue,
inserts, deletes and rebuilds run replicated on every rank.  The file
runs itself as a script on the rank harness of
``tests/test_torch_sharded_planes.py``; meanwhile pytest replays the
serving cases on both packages' replicated engines.  The serving cases
are those of ``tests/test_torch_sharded_engine.py`` (bool, packed and
``il`` indexes, both consistency modes, submit, insert, delete, delta and
auto rebuilds, flushes, a deadline flush under skewed rank clocks), with
``bfs_kernel=True`` on the mesh engines, and a server stream with the
lazy and a forced rebuild on the streamed kernels' plain versions.  Then
a collective audit (one all-gather per label phase and nothing else) and
the refusals.  The replicated engine's and server's stats, keys and
values, are held against the JAX package's as well.
"""
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import distributed as TD
from repro_torch.core import graph as TG
from repro_torch.graphs.generators import power_law
from repro_torch.kernels.dbl_query.ops import StreamILFallbackWarning
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer
from tests.test_torch_sharded_engine import (ENG, FAM, K, SERVE_CASES,
                                             ServeRun, TorchServe, _keys,
                                             _rand, _same_on_ranks,
                                             jax_serve)
from tests.test_torch_sharded_planes import (WORLD, finish_world,
                                             script_main, start_world)


# ------------------------------------------------------------- runners
class MeshRun(ServeRun):
    """A serving case on this rank: the port's replicated index behind
    ``QueryEngine(mesh=<query mesh>, bfs_kernel=True)``."""

    def index(self, g, steps=(), **kw):
        return ServeRun(None, self.rec, self.case).index(g, steps, **kw)

    def engine(self, idx, **kw):
        return TEngine(idx, mesh=self.mesh, bfs_kernel=True, **kw)

    def server(self, idx, **kw):
        eng = TEngine(idx, mesh=self.mesh, bfs_kernel=True, streaming=True,
                      **ENG)
        return ReachabilityServer(None, engine=eng, **kw)


def _server(run, idx, **kw):
    """A server over ``run``'s engine: the mesh engine on a rank, the
    package's replicated engine in a replay."""
    if isinstance(run, MeshRun):
        return run.server(idx, **kw)
    if run.api is TorchServe:
        return ReachabilityServer(None, engine=run.engine(idx, **ENG), **kw)
    from repro.serve.reach_server import ReachabilityServer as JServer
    return JServer(None, engine=run.engine(idx, **ENG), **kw)


# ------------------------------------------------------- serving cases
def server_stream(run):
    """``ReachabilityServer`` with the lazy rebuild (dead ratio 0.02):
    query, submit -> insert -> flush rounds, a delete that makes the
    rebuild due (it runs at the next query), a forced full rebuild, and
    the counters at the end."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=11)
    idx = run.index(run.graph(src, dst, n, m + 1024), n_cap=n, **K)
    srv = _server(run, idx, rebuild_dead_ratio=0.02, rebuild_mode="auto")
    rng = np.random.default_rng(8)
    for r in range(5):
        run.put(f"query{r}", "ans", np.asarray(srv.query(*_rand(rng, n,
                                                                 200))))
        srv.submit(*_rand(rng, n, 96))
        srv.insert(*_rand(rng, n, 16))
        srv.submit(*_rand(rng, n, 96))
        for i, a in enumerate(srv.flush()):
            run.put(f"flush{r}", f"ans{i}", np.asarray(a))
        if r == 1:
            srv.delete(src[:40], dst[:40])
            run.put(f"delete{r}", "due", np.array(srv._rebuild_due))
        if r == 3:
            srv.rebuild(mode="full")
            run.put_dict(f"rebuild{r}", "info",
                         srv.engine.last_rebuild_info)
    st = srv.stats.as_dict()
    run.put_dict("end", "serve", {k: v for k, v in st.items()
                                  if not k.endswith("_s")})
    run.stats("end", srv.engine)


MESH_CASES = {name: SERVE_CASES[name] for name in (
    "engine_stream_asof", "engine_stream_latest", "engine_stream_packed",
    "engine_stream_il", "dirty_query", "packed_engine_query",
    "deadline_flush_skewed")}
MESH_CASES["server_stream"] = server_stream


# ------------------------------------------------ rank-only cases
def _verdict_index(il):
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=21)
    g = TG.make_graph(src, dst, n, m_cap=m + 64, device="cpu")
    return TIndex.build(g, n_cap=n, device="cpu", **K, **(FAM if il else {}))


#: a batch that is not a multiple of the mesh size
VERDICT_Q = 1001


def label_verdicts(run):
    """``distributed_label_verdicts`` on a default and an "il" index."""
    for il in (False, True):
        idx = _verdict_index(il)
        u, v = _rand(np.random.default_rng(3), idx.n_cap, VERDICT_Q)
        run.put("verdicts", f"il{int(il)}", TD.distributed_label_verdicts(
            idx, run.mesh, u, v).numpy())


class _Counts:
    """Counts every collective while installed."""
    NAMES = ("all_reduce", "all_to_all_single", "all_gather",
             "all_gather_into_tensor", "all_gather_single", "broadcast",
             "reduce_scatter_tensor", "barrier")

    def __enter__(self):
        self.n, self.saved = dict.fromkeys(self.NAMES, 0), {}
        for name in self.NAMES:
            if not hasattr(dist, name):
                continue
            self.saved[name] = fn = getattr(dist, name)

            def call(*a, _f=fn, _n=name, **kw):
                self.n[_n] += 1
                return _f(*a, **kw)
            setattr(dist, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)

    def take(self):
        out = {k: v for k, v in self.n.items() if v}
        self.n = dict.fromkeys(self.NAMES, 0)
        return out


def collective_audit(run):
    """The collectives of each serving step on a mesh engine: a submit,
    its resolve, an insert, a delete, a rebuild, and a deadline poll."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=1)
    g = TG.make_graph(src, dst, n, m_cap=m + 64, device="cpu")
    idx = TIndex.build(g, n_cap=n, device="cpu", **K)
    eng = TEngine(idx, mesh=run.mesh, bfs_kernel=True,
                  flush_policy="deadline", flush_deadline_ms=1e9, **ENG)
    rng = np.random.default_rng(2)
    steps = {}
    with _Counts() as c:
        pend = eng.submit(eng.index, *_rand(rng, n, 300))
        steps["submit"] = c.take()
        pend.resolve()
        steps["resolve"] = c.take()
        eng.insert(*_rand(rng, n, 16))
        steps["insert"] = c.take()
        eng.delete(src[:20], dst[:20])
        steps["delete"] = c.take()
        eng.rebuild(mode="delta")
        steps["rebuild"] = c.take()
        eng.submit(eng.index, *_rand(rng, n, 40))
        steps["dirty_submit"] = c.take()
    run.put("audit", "steps", np.array(json.dumps(steps)))
    run.put("audit", "nu", np.array(pend.nu))


RANK_CASES = {"label_verdicts": label_verdicts,
              "collective_audit": collective_audit}
CASES = {**MESH_CASES, **RANK_CASES}


def mesh_runner(mesh, rec, case):
    """Each case gets the query mesh over the rank's group."""
    qmesh = TD.query_mesh(WORLD, device="cpu")
    return MeshRun(qmesh, rec, case)


# ----------------------------------------------------------- pytest side
def replay():
    """Each serving case on both packages' replicated engines."""
    reps = {}
    for key, api in (("jax", jax_serve()), ("torch", TorchServe)):
        rec = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", StreamILFallbackWarning)
            for name, fn in MESH_CASES.items():
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


@pytest.mark.parametrize("ref", ["jax", "torch"])
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_answers_bitwise(world, case, ref):
    """Every answer and flag of the stream equals the replicated
    engine's."""
    ranks, reps = world
    rep = reps[ref]
    keys = [k for k in _keys(rep, case)
            if k.split("|")[2] not in ("stats", "info", "serve")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(_same_on_ranks(ranks, k), rep[k],
                                      err_msg=f"{k} vs {ref}")


@pytest.mark.parametrize("ref", ["jax", "torch"])
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_stats_and_rebuild_info_equal(world, case, ref):
    """``EngineStats``, the rebuild info and the server's counters equal
    the replicated engine's, field for field, on every rank."""
    ranks, reps = world
    rep = reps[ref]
    keys = [k for k in _keys(rep, case)
            if k.split("|")[2] in ("stats", "info", "serve")]
    if case != "deadline_flush_skewed":
        assert keys, case
    for k in keys:
        assert json.loads(str(_same_on_ranks(ranks, k))) == rep[k], \
            (k, ref)


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_distributed_label_verdicts(world, ref):
    ranks, _ = world
    for il in (False, True):
        got = _same_on_ranks(ranks, f"label_verdicts|verdicts|il{int(il)}")
        assert got.shape == (VERDICT_Q,) and got.dtype == np.int8
        idx = _verdict_index(il)
        u, v = _rand(np.random.default_rng(3), idx.n_cap, VERDICT_Q)
        if ref == "torch":
            want = idx.label_verdicts(u, v).numpy()
        else:
            from repro.core import DBLIndex as JIndex
            from repro.core import graph as JG
            src, dst = power_law(256, 1400, seed=21)
            jidx = JIndex.build(JG.make_graph(src, dst, 256, m_cap=1464),
                                n_cap=256, **K, **(FAM if il else {}))
            want = np.asarray(jidx.label_verdicts(u, v))
        np.testing.assert_array_equal(got, want, err_msg=f"il={il}")


def test_mesh_collective_audit(world):
    """One all-gather per label phase and nothing else; the residue,
    insert, delete and rebuild run replicated with no collective; the
    deadline poll after a submit agrees by one all_reduce."""
    ranks, _ = world
    steps = json.loads(str(_same_on_ranks(ranks,
                                          "collective_audit|audit|steps")))
    assert int(ranks[0]["collective_audit|audit|nu"]) > 0
    for name in ("submit", "dirty_submit"):
        got = dict(steps[name])
        polls = got.pop("all_reduce", 0)
        assert polls == 1, (name, steps[name])      # the deadline poll
        gathers = sum(got.pop(k, 0) for k in ("all_gather_into_tensor",
                                              "all_gather_single"))
        assert gathers == 1 and not got, (name, steps[name])
    for name in ("resolve", "insert", "delete", "rebuild"):
        assert steps[name] == {}, (name, steps[name])


# ------------------------------------------- in-process checks
def _q_mesh(rank=0, axis=TD.QUERY_AXIS):
    """A mesh handle for code that runs no collective."""
    return TD.VertexMesh(None, rank, WORLD, torch.device("cpu"), axis)


def _small_index():
    src, dst = power_law(64, 300, seed=4)
    g = TG.make_graph(src, dst, 64, device="cpu")
    return TIndex.build(g, n_cap=64, device="cpu", **K)


def test_query_mesh_binds_the_replicated_index():
    idx = _small_index()
    eng = TEngine(idx, mesh=_q_mesh(), bfs_kernel=True, streaming=True,
                  bfs_chunk=16)
    assert eng.index is idx and eng.layout == "replicated"
    assert eng.mesh.axis == "query" and eng.backend == "torch"
    srv = ReachabilityServer(idx, mesh=_q_mesh(), bfs_chunk=16)
    assert srv.engine.mesh is not None
    es = srv.engine_stats()
    assert es["layout"] == "replicated" and es["halo_bytes"] == 0
    assert es["halo"]["mode"] == "dense" and es["halo"]["fixpoints"] == 0


@pytest.mark.parametrize("kw, err, match", [
    (dict(mesh=object()), TypeError, "query_mesh"),
    (dict(mesh=_q_mesh(axis="vertex")), TypeError, "vertex_mesh="),
    (dict(mesh=_q_mesh(), vertex_mesh=_q_mesh(axis="vertex")), ValueError,
     "mutually exclusive"),
])
def test_mesh_refusals(kw, err, match):
    with pytest.raises(err, match=match):
        TEngine(_small_index(), **kw)


def test_mesh_refuses_a_shard_and_the_aot_cache():
    idx = _small_index()
    shard = TD.place_vertex_sharded(idx, _q_mesh(1, axis="vertex"))
    with pytest.raises(ValueError, match="vertex_mesh="):
        TEngine(shard, mesh=_q_mesh())
    with pytest.raises(ValueError, match="vertex_mesh="):
        TD.distributed_label_verdicts(shard, _q_mesh(), [0], [1])
    eng = TEngine(idx, mesh=_q_mesh())
    # the reference's refusal: the cache serves the replicated layout only
    with pytest.raises(ValueError, match="replicated single-process"):
        eng.aot_warmup(idx, "cache")


def test_query_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="query_mesh needs"):
        TD.query_mesh(device="cpu")


def test_replicated_stats_keys_equal_reference():
    """The replicated engine's ``EngineStats`` and the server's
    ``engine_stats()`` after the same stream: the JAX package's keys and
    values, ``dispatch_shapes`` included, apart from the port's
    ``device`` and the backend's name."""
    from repro.core import DBLIndex as JIndex
    from repro.core import graph as JG
    from repro.serve.engine import QueryEngine as JEngine
    from repro.serve.reach_server import ReachabilityServer as JServer
    n, m = 128, 600
    src, dst = power_law(n, m, seed=2)
    out = []
    for build, Engine, Server in (
            (lambda: TIndex.build(TG.make_graph(src, dst, n, m_cap=m + 64,
                                                device="cpu"),
                                  n_cap=n, device="cpu", **K),
             TEngine, ReachabilityServer),
            (lambda: JIndex.build(JG.make_graph(src, dst, n, m_cap=m + 64),
                                  n_cap=n, **K), JEngine, JServer)):
        srv = Server(None, engine=Engine(build(), **ENG),
                     rebuild_dead_ratio=None)
        rng = np.random.default_rng(5)
        srv.query(*_rand(rng, n, 100))
        srv.insert(*_rand(rng, n, 12))
        srv.delete(src[:10], dst[:10])
        srv.query(*_rand(rng, n, 100))
        srv.rebuild(mode="delta")
        out.append((srv.engine.stats.as_dict(), srv.engine_stats()))
    (t_stats, t_srv), (j_stats, j_srv) = out
    assert t_stats == j_stats
    for k in ("halo_bytes", "halo_rounds", "quiet_pair_rounds"):
        assert t_stats[k] == 0
    assert set(t_srv) - {"device"} == set(j_srv)
    for k in set(t_srv) - {"device", "backend"}:
        assert t_srv[k] == j_srv[k], k


if __name__ == "__main__":
    script_main(sys.argv[1:], CASES, mesh_runner)
