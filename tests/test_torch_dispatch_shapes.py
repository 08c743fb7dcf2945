"""``QueryEngine.dispatch_shape_counts``/``dispatch_shapes``/``warmup``
and the server's ``engine_stats()["dispatch_shapes"]``, held against the
JAX package's jit cache counts.

A dispatch shape is a distinct input signature that the label phase or a
chunk bucket's coalesced residue was dispatched with; the port counts
them where the reference counts its jit cache entries.  The streams are
the twins of ``tests/test_engine.py``'s and ``tests/test_delta_rebuild.py``'s
dispatch-shape tests: each runs on both packages, and the port's counts
equal the reference's at every checkpoint, except on the stream of many
batch sizes, where the port pads a batch to a multiple of ``bfs_chunk``
and the reference to a multiple of ``lcm(q_block, bfs_chunk)``: there the
port's label count is the number of its own padded sizes.

The mesh engines warm their own phases in a world of 4 gloo ranks (the
file is also the script that runs them, on the harness of
``tests/test_torch_sharded_planes.py``): the twins of
``tests/distributed/run_sharded_planes.py``'s and
``run_plan_extension.py``'s budgets on a vertex mesh, and a launch-mesh
query engine.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import graph as TG
from repro_torch.graphs.generators import power_law
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer as TServer
from tests.conftest import reach_oracle
from tests.test_torch_sharded_planes import (finish_world, script_main,
                                             start_world)


class TorchAPI:
    Engine = TEngine
    Server = TServer

    @staticmethod
    def index(src, dst, n, m_cap, **kw):
        g = TG.make_graph(src, dst, n, m_cap=m_cap, device="cpu")
        return TIndex.build(g, n_cap=n, device="cpu", **kw)


def jax_api():
    from repro.core import DBLIndex as JIndex
    from repro.core import make_graph
    from repro.serve.engine import QueryEngine as JEngine
    from repro.serve.reach_server import ReachabilityServer as JServer

    class JaxAPI:
        Engine = JEngine
        Server = JServer

        @staticmethod
        def index(src, dst, n, m_cap, **kw):
            return JIndex.build(make_graph(src, dst, n, m_cap=m_cap),
                                n_cap=n, **kw)
    return JaxAPI


def _power_law_index(api, n=256, m=1200, *, k=8, kp=8, m_extra=64,
                     max_iters=64):
    src, dst = power_law(n, m, seed=5)
    return api.index(src, dst, n, m + m_extra, k=k, k_prime=kp,
                     max_iters=max_iters), src, dst


def _rand(rng, n, q):
    return (rng.integers(0, n, q).astype(np.int32),
            rng.integers(0, n, q).astype(np.int32))


# ------------------------------------------------------------ streams
def batch_10k(api):
    """``test_engine.py``'s 10k batch: one label and one BFS shape."""
    idx, src, dst = _power_law_index(api)
    u, v = _rand(np.random.default_rng(0), 256, 10_000)
    eng = api.Engine(idx, bfs_chunk=256, max_iters=64)
    ans, info = eng.run(idx, u, v, return_stats=True)
    host = idx.query(u, v, bfs_chunk=256, max_iters=64, driver="host")
    return {"counts": [eng.dispatch_shape_counts()],
            "n_bfs": info["n_bfs"], "ans": np.asarray(ans),
            "host": np.asarray(host),
            "oracle": reach_oracle(256, src, dst)[u, v]}


def delta_rebuild(api):
    """``test_delta_rebuild.py``'s re-bind: warmup, a query, a delete and
    a delta rebuild, a query; no new shape after the warmup."""
    from tests.test_delta_rebuild import Mirror
    rng = np.random.default_rng(7)
    n = 48
    src = rng.integers(0, n, 160).astype(np.int32)
    dst = rng.integers(0, n, 160).astype(np.int32)
    idx = api.index(src, dst, n, 224, k=4, k_prime=4, max_iters=50)
    eng = api.Engine(idx, bfs_chunk=32, max_iters=50)
    eng.warmup(idx, batch_sizes=(600,), bfs_buckets=(16, 32))
    counts = [eng.dispatch_shape_counts()]
    u, v = _rand(rng, n, 600)
    eng.query(u, v)
    counts.append(eng.dispatch_shape_counts())
    mirror = Mirror(src, dst)
    eng.delete(src[:10], dst[:10])
    mirror.delete(src[:10], dst[:10])
    eng.rebuild(mode="delta")
    ans = eng.query(u, v)
    counts.append(eng.dispatch_shape_counts())
    return {"counts": counts, "mode": eng.last_rebuild_info["mode"],
            "ans": np.asarray(ans), "oracle": mirror.oracle(n)[u, v]}


def dirty_flips(api):
    """``test_deletions.py``'s dirty on/off stream: the dirty flag makes
    no new shape."""
    rng = np.random.default_rng(0)
    n = 48
    src = rng.integers(0, n, 160).astype(np.int32)
    dst = rng.integers(0, n, 160).astype(np.int32)
    idx = api.index(src, dst, n, 224, k=4, k_prime=4, max_iters=50)
    eng = api.Engine(idx, bfs_chunk=32, max_iters=50)
    eng.warmup(idx, batch_sizes=(600,), bfs_buckets=(16, 32))
    u, v = _rand(rng, n, 600)
    eng.query(u, v)
    counts = [eng.dispatch_shape_counts()]
    eng.delete(src[:30], dst[:30])
    eng.query(u, v)
    eng.rebuild()
    eng.query(u, v)
    eng.delete(src[30:60], dst[30:60])
    eng.query(u, v)
    counts.append(eng.dispatch_shape_counts())
    return {"counts": counts}


def mixed_epochs(api):
    """``test_engine.py``'s mixed-epoch 10k stream: cross-epoch flushes
    keep one BFS shape."""
    idx, src, dst = _power_law_index(api, m_extra=256)
    rng = np.random.default_rng(11)
    eng = api.Engine(idx, bfs_chunk=256, max_iters=64)
    pendings = []
    for _ in range(3):
        for q in (2000, 1500):
            pendings.append(eng.submit(eng.index, *_rand(rng, 256, q)))
        eng.insert(*_rand(rng, 256, 32))
    pendings.append(eng.submit(eng.index, *_rand(rng, 256, 2500)))
    outs = eng.flush(pendings)
    return {"counts": [eng.dispatch_shape_counts()],
            "stale": eng.stats.stale_lanes,
            "ans": np.concatenate([np.asarray(o) for o in outs])}


def warmup_then_run(api):
    """``test_engine.py``'s warmup: a served batch after it adds
    nothing."""
    idx, _, _ = _power_law_index(api, n=64, m=160, m_extra=8, max_iters=40)
    eng = api.Engine(idx, bfs_chunk=64, max_iters=40)
    eng.warmup(idx, batch_sizes=(1, 600), bfs_buckets=(16, 32, 64))
    counts = [eng.dispatch_shape_counts()]
    eng.run(idx, *_rand(np.random.default_rng(5), 64, 600))
    counts.append(eng.dispatch_shape_counts())
    return {"counts": counts}


def server_round_trip(api):
    """``test_engine.py``'s server round trip: ``engine_stats()``."""
    idx, _, _ = _power_law_index(api, n=128, m=500, m_extra=32)
    srv = api.Server(idx, bfs_chunk=128, max_iters=64)
    srv.query(*_rand(np.random.default_rng(4), 128, 3000))
    srv.insert([0, 1], [2, 3])
    es = srv.engine_stats()
    return {"counts": [srv.engine.dispatch_shape_counts()],
            "engine_stats": es["dispatch_shapes"]}


STREAMS = {"batch_10k": batch_10k, "delta_rebuild": delta_rebuild,
           "dirty_flips": dirty_flips, "mixed_epochs": mixed_epochs,
           "warmup_then_run": warmup_then_run,
           "server_round_trip": server_round_trip}

#: ``test_engine.py``'s eight batch sizes
SIZES = (3, 64, 500, 512, 513, 900, 1024, 1500)


def many_sizes(api):
    idx, src, dst = _power_law_index(api)
    rng = np.random.default_rng(1)
    eng = api.Engine(idx, bfs_chunk=256, max_iters=64, q_block=512)
    R = reach_oracle(256, src, dst)
    ok = True
    for q in SIZES:
        u, v = _rand(rng, 256, q)
        ok &= bool((np.asarray(eng.run(idx, u, v)) == R[u, v]).all())
    return {"counts": [eng.dispatch_shape_counts()], "ok": ok,
            "shapes": eng.dispatch_shapes()}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for key, api in (("torch", TorchAPI), ("jax", jax_api())):
        out[key] = {name: fn(api) for name, fn in
                    {**STREAMS, "many_sizes": many_sizes}.items()}
    return out


@pytest.mark.parametrize("stream", list(STREAMS))
def test_counts_equal_reference(runs, stream):
    assert runs["torch"][stream]["counts"] == runs["jax"][stream]["counts"]


def test_10k_batch_two_dispatch_shapes(runs):
    r = runs["torch"]["batch_10k"]
    assert r["n_bfs"] > 0
    assert sum(r["counts"][0].values()) <= 2
    np.testing.assert_array_equal(r["ans"], r["host"])
    np.testing.assert_array_equal(r["ans"], r["oracle"])


def test_delta_rebuild_adds_no_shape(runs):
    r = runs["torch"]["delta_rebuild"]
    assert r["mode"] == "delta"
    assert r["counts"][0] == r["counts"][1] == r["counts"][2]
    np.testing.assert_array_equal(r["ans"], r["oracle"])


def test_dirty_flag_adds_no_shape(runs):
    a, b = runs["torch"]["dirty_flips"]["counts"]
    assert a == b


def test_mixed_epochs_one_bfs_shape(runs):
    r = runs["torch"]["mixed_epochs"]
    assert r["stale"] > 0 and r["counts"][0]["bfs"] <= 2
    np.testing.assert_array_equal(r["ans"], runs["jax"]["mixed_epochs"]["ans"])


def test_warmup_covers_the_served_batch(runs):
    a, b = runs["torch"]["warmup_then_run"]["counts"]
    assert sum(a.values()) >= 2 and a == b


def test_server_engine_stats_dispatch_shapes(runs):
    r = runs["torch"]["server_round_trip"]
    assert r["engine_stats"] == sum(r["counts"][0].values()) <= 2
    assert r["engine_stats"] == runs["jax"]["server_round_trip"][
        "engine_stats"]


def test_many_batch_sizes_under_the_ports_bound(runs):
    """Eight batch sizes: the port pads to multiples of ``bfs_chunk``
    (256), so its label signatures are the distinct padded sizes (five:
    256, 512, 768, 1024, 1536), where the reference's ``lcm(q_block,
    bfs_chunk)`` = 512 granule gives three; the BFS signatures are one a
    chunk bucket hit, as in the reference (the residues are equal)."""
    r, j = runs["torch"]["many_sizes"], runs["jax"]["many_sizes"]
    assert r["ok"]
    padded = {max(256, -(-q // 256) * 256) for q in SIZES}
    assert r["counts"][0]["label"] == len(padded) == 5
    assert j["counts"][0]["label"] <= 3
    assert r["counts"][0]["bfs"] == j["counts"][0]["bfs"]
    buckets = len(TEngine(bfs_chunk=256, device="cpu")._chunk_buckets())
    assert r["shapes"] <= len(padded) + buckets


def test_warmup_refuses_a_foreign_device_index():
    idx, _, _ = _power_law_index(TorchAPI, n=64, m=160, m_extra=8)
    eng = TEngine(bfs_chunk=64, device="meta")
    with pytest.raises(ValueError, match="index lives on"):
        eng.warmup(idx)
    assert eng.dispatch_shapes() == 0


def test_warmup_needs_no_kernel_library_on_the_cpu():
    idx, _, _ = _power_law_index(TorchAPI, n=64, m=160, m_extra=8)
    eng = TEngine(idx, bfs_chunk=64, bfs_kernel=True, streaming=True)
    assert eng._kernel_libraries(idx) == []
    eng.warmup(idx)
    assert eng.dispatch_shape_counts() == {"label": 1, "bfs": 1}


# --------------------------------------------------- the gloo world
def vertex_budget(run):
    """``run_sharded_planes.py``'s budget: a warmed vertex-sharded engine
    serves a stream of queries, submits, inserts, a delete and flushes
    with no new shape after the fourth round; its answers equal the
    replicated engine's."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=9)
    g = TG.make_graph(src, dst, n, m_cap=m + 1024, device="cpu")
    ref = TIndex.build(g, n_cap=n, device="cpu", k=16, k_prime=16,
                       max_iters=64)
    eng_r = TEngine(ref, bfs_chunk=64, max_iters=64)
    eng_s = TEngine(ref, bfs_chunk=64, max_iters=64, vertex_mesh=run.mesh)
    eng_s.warmup(eng_s.index, bfs_buckets=eng_s._chunk_buckets())
    run.rec["vertex|warm"] = np.array(json.dumps(
        eng_s.dispatch_shape_counts()))
    rng = np.random.default_rng(4)
    pend_r, pend_s, same, warm = [], [], True, None
    for r in range(8):
        u, v = _rand(rng, n, 96)
        same &= bool((eng_r.query(u, v) == eng_s.query(u, v)).all())
        pend_r.append(eng_r.submit(eng_r.index, u, v))
        pend_s.append(eng_s.submit(eng_s.index, u, v))
        ns, nd = _rand(rng, n, 24)
        eng_r.insert(ns, nd)
        eng_s.insert(ns, nd)
        if r == 4:
            eng_r.delete(src[:20], dst[:20])
            eng_s.delete(src[:20], dst[:20])
        if r == 3:
            for a, b in zip(eng_r.flush(pend_r), eng_s.flush(pend_s)):
                same &= bool((a == b).all())
            pend_r, pend_s = [], []
            warm = eng_s.dispatch_shapes()
    for a, b in zip(eng_r.flush(pend_r), eng_s.flush(pend_s)):
        same &= bool((a == b).all())
    run.rec["vertex|same"] = np.bool_(same)
    run.rec["vertex|shapes"] = np.array([warm, eng_s.dispatch_shapes()])


def extension_budget(run):
    """``run_plan_extension.py``'s in-granule stream: once warm, inserts
    that extend the plan within its padded extents add no shape."""
    from tests.test_torch_sharded_planes import clean_batch
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=19)
    g = TG.make_graph(src, dst, n, m_cap=m + 2048, device="cpu")
    ref = TIndex.build(g, n_cap=n, device="cpu", k=16, k_prime=16,
                       max_iters=64)
    eng = TEngine(ref, bfs_chunk=64, max_iters=64, vertex_mesh=run.mesh)
    eng.warmup(eng.index, bfs_buckets=eng._chunk_buckets())
    rng = np.random.default_rng(23)
    eng.insert(*clean_batch(rng, n, 24))
    eng.flush([eng.submit(eng.index, *_rand(rng, n, 96))])
    extents = (eng._plan.fwd.e_recv.shape, eng._plan.fwd.h_send.shape)
    warm = eng.dispatch_shapes()
    for _ in range(4):
        eng.insert(*clean_batch(rng, n, 24))
        eng.flush([eng.submit(eng.index, *_rand(rng, n, 96))])
    run.rec["extension|same_extents"] = np.bool_(
        extents == (eng._plan.fwd.e_recv.shape, eng._plan.fwd.h_send.shape))
    run.rec["extension|shapes"] = np.array([warm, eng.dispatch_shapes()])


def launch_mesh_warmup(run):
    """A query engine over a (2, 2) launch mesh: the shapes after its
    warmup, after a served round and after a delta rebuild are equal, and
    its answers equal the replicated engine's."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=2)
    g = TG.make_graph(src, dst, n, m_cap=m + 64, device="cpu")
    idx = TIndex.build(g, n_cap=n, device="cpu", k=16, k_prime=16,
                       max_iters=64)
    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    eng = TEngine(idx, mesh=mesh, bfs_chunk=64, max_iters=64,
                  bfs_kernel=True)
    eng_r = TEngine(idx, bfs_chunk=64, max_iters=64)
    eng.warmup(eng.index, batch_sizes=(200,),
               bfs_buckets=eng._chunk_buckets())
    shapes = [eng.dispatch_shapes()]
    u, v = _rand(np.random.default_rng(6), n, 200)
    same = bool((eng.query(u, v) == eng_r.query(u, v)).all())
    shapes.append(eng.dispatch_shapes())
    for e in (eng, eng_r):
        e.delete(src[:20], dst[:20])
        e.rebuild(mode="delta")
    same &= bool((eng.query(u, v) == eng_r.query(u, v)).all())
    shapes.append(eng.dispatch_shapes())
    run.rec["launch|same"] = np.bool_(same)
    run.rec["launch|shapes"] = np.array(shapes)


class _Run:
    def __init__(self, mesh, rec, case):
        self.mesh, self.rec, self.case = mesh, rec, case


CASES = {"vertex_budget": vertex_budget,
         "extension_budget": extension_budget,
         "launch_mesh_warmup": launch_mesh_warmup}


@pytest.fixture(scope="module")
def world():
    proc, out_dir = start_world(Path(__file__), list(CASES))
    return finish_world(proc, out_dir)


def test_vertex_engine_warmup_budget(world):
    for r in world:
        assert bool(r["vertex|same"])
        warm, end = (int(x) for x in r["vertex|shapes"])
        assert warm == end
        counts = json.loads(str(r["vertex|warm"]))
        # the label phase and every chunk bucket (16, 32, 64)
        assert counts == {"label": 1, "bfs": 3}


def test_vertex_engine_in_granule_extension_budget(world):
    for r in world:
        assert bool(r["extension|same_extents"])
        warm, end = (int(x) for x in r["extension|shapes"])
        assert warm == end


def test_launch_mesh_engine_warmup(world):
    for r in world:
        assert bool(r["launch|same"])
        a, b, c = (int(x) for x in r["launch|shapes"])
        assert a == b == c


if __name__ == "__main__":
    script_main(sys.argv[1:], CASES, _Run)
