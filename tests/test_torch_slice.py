"""The served slice as a whole: DBLIndex build/query/insert, the
QueryEngine pipeline and the ReachabilityServer of the port, held bitwise
against the JAX package and the dense reachability oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import DBLIndex as JIndex
from repro.core import graph as JG
from repro.core import query as JQ
from repro.graphs import generators as JGen
from repro.serve.engine import QueryEngine as JEngine
from repro.serve.reach_server import ReachabilityServer as JServer
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import make_graph as t_make_graph
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer as TServer
from tests.conftest import reach_oracle

CPU = "cpu"
_PLANES = ("dl_in", "dl_out", "bl_in", "bl_out")


def jax_to_numpy(idx) -> dict:
    g = idx.graph
    out = {f"graph.{f}": np.asarray(getattr(g, f))
           for f in ("src", "dst", "n", "m", "del_at", "del_epoch")}
    for f in ("landmarks", *_PLANES, "bl_sources", "bl_sinks", "epoch",
              "label_del_epoch", "saturated"):
        out[f] = np.asarray(getattr(idx, f))
    for f in _PLANES:
        out[f"packed.{f}"] = np.asarray(getattr(idx.packed, f))
    return out


def numpy_to_jax(a: dict):
    g = JG.Graph(*(jnp.asarray(a[f"graph.{f}"], jnp.int32)
                   for f in ("src", "dst", "n", "m", "del_at", "del_epoch")))
    planes = [jnp.asarray(a[f], jnp.uint8) for f in _PLANES]
    return JIndex(g, jnp.asarray(a["landmarks"], jnp.int32), *planes,
                  JQ.pack_labels(*planes), jnp.asarray(a["bl_sources"]),
                  jnp.asarray(a["bl_sinks"]),
                  epoch=jnp.int32(a["epoch"]),
                  label_del_epoch=jnp.int32(a["label_del_epoch"]),
                  saturated=jnp.asarray(bool(a["saturated"])))


def assert_same_index(jidx, tidx):
    want = jax_to_numpy(jidx)
    got = tidx.to_numpy()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def _graph(kind, n, m, seed):
    if kind == "power_law":
        return JGen.power_law(n, m, seed=seed)
    if kind == "dag_like":
        return JGen.dag_like(n, m, seed=seed, back_frac=0.05)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(np.int32),
            rng.integers(0, n, m).astype(np.int32))


def _pair(kind, n=160, m=480, seed=0, k=16, kp=16, extra=40, max_iters=64):
    src, dst = _graph(kind, n, m, seed)
    jidx = JIndex.build(JG.make_graph(src, dst, n, m_cap=m + extra),
                        n_cap=n, k=k, k_prime=kp, max_iters=max_iters)
    tidx = TIndex.build(t_make_graph(src, dst, n, m_cap=m + extra,
                                     device=CPU),
                        n_cap=n, k=k, k_prime=kp, max_iters=max_iters,
                        device=CPU)
    return jidx, tidx, src, dst


@pytest.mark.parametrize("kind,k,kp", [("power_law", 16, 16),
                                       ("dag_like", 32, 8),
                                       ("random", 40, 24)])
def test_index_build_query_insert_query(kind, k, kp):
    n = 160
    jidx, tidx, src, dst = _pair(kind, n=n, k=k, kp=kp)
    assert_same_index(jidx, tidx)
    rng = np.random.default_rng(1)
    u = rng.integers(0, n, 600).astype(np.int32)
    v = rng.integers(0, n, 600).astype(np.int32)
    R = reach_oracle(n, src, dst)
    got_e = tidx.query(u, v, bfs_chunk=32, max_iters=64)
    got_h = tidx.query(u, v, bfs_chunk=32, max_iters=64, driver="host")
    np.testing.assert_array_equal(got_e, R[u, v])
    np.testing.assert_array_equal(got_h, R[u, v])
    np.testing.assert_array_equal(got_e, np.asarray(
        jidx.query(u, v, bfs_chunk=32, max_iters=64)))
    np.testing.assert_array_equal(
        tidx.label_verdicts(u, v).numpy(),
        np.asarray(jidx.label_verdicts(u, v)))
    ns = rng.integers(0, n, 25).astype(np.int32)
    nd = rng.integers(0, n, 25).astype(np.int32)
    jidx = jidx.insert_edges(ns, nd, max_iters=64)
    tidx = tidx.insert_edges(ns, nd, max_iters=64)
    assert_same_index(jidx, tidx)
    R = reach_oracle(n, np.concatenate([src, ns]), np.concatenate([dst, nd]))
    np.testing.assert_array_equal(
        tidx.query(u, v, bfs_chunk=32, max_iters=64), R[u, v])
    np.testing.assert_array_equal(
        tidx.query(u, v, bfs_chunk=32, max_iters=64, driver="host"),
        R[u, v])
    assert tidx.label_bytes() == jidx.label_bytes()
    # float32 means, summed in another order than XLA's
    assert tidx.density() == pytest.approx(jidx.density(), rel=1e-6)


_STATS = ("queries", "label_answered", "bfs_answered", "bfs_dispatches",
          "batches", "inserts", "stale_lanes", "flushes", "prune_hits")


@pytest.mark.parametrize("consistency", ["as-of-submit", "latest"])
@pytest.mark.parametrize("bfs_kernel,frontier", [(False, "int8"),
                                                 (True, "int32")])
def test_engine_submit_insert_submit_flush(consistency, bfs_kernel,
                                           frontier):
    n = 200
    jidx, tidx, src, dst = _pair("dag_like", n=n, m=420, seed=3, k=16, kp=8,
                                 extra=60)
    kw = dict(bfs_chunk=32, max_iters=64, consistency=consistency,
              bfs_kernel=bfs_kernel, frontier_dtype=frontier)
    je = JEngine(jidx, **kw)
    te = TEngine(tidx, **kw)
    assert te.backend == "torch" and te.device.type == "cpu"
    rng = np.random.default_rng(2)
    b1 = [rng.integers(0, n, 300).astype(np.int32) for _ in range(2)]
    b2 = [rng.integers(0, n, 180).astype(np.int32) for _ in range(2)]
    ns = rng.integers(0, n, 30).astype(np.int32)
    nd = rng.integers(0, n, 30).astype(np.int32)
    outs = []
    for e in (je, te):
        p1 = e.submit(e.index, *b1)
        e.insert(ns, nd)
        p2 = e.submit(e.index, *b2)
        outs.append(e.flush([p1, p2]))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), b)
    R0 = reach_oracle(n, src, dst)
    R1 = reach_oracle(n, np.concatenate([src, ns]), np.concatenate([dst, nd]))
    assert outs[1][1].tolist() == R1[b2[0], b2[1]].tolist()
    got0 = outs[1][0]
    if consistency == "as-of-submit":
        np.testing.assert_array_equal(got0, R0[b1[0], b1[1]])
    else:
        # label-phase answers are final at submit; the residue sees the
        # newest snapshot, so every answer lies between the two closures
        assert (got0 >= R0[b1[0], b1[1]]).all()
        assert (got0 <= R1[b1[0], b1[1]]).all()
    for key in _STATS:
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    assert te.stats.bfs_answered > 0
    assert sum(te.stats.prune_hits.values()) == te.stats.queries
    assert_same_index(je.index, te.index)


def test_server_three_rounds_match():
    n = 180
    jidx, tidx, src, dst = _pair("power_law", n=n, m=500, seed=7, k=16,
                                 kp=16, extra=60)
    js = JServer(jidx, bfs_chunk=32, max_iters=64)
    ts = TServer(tidx, bfs_chunk=32, max_iters=64)
    rng = np.random.default_rng(4)
    es, ed = list(src), list(dst)
    for r in range(3):
        u = rng.integers(0, n, 400).astype(np.int32)
        v = rng.integers(0, n, 400).astype(np.int32)
        if r == 1:   # the pipelined surface, across an insert
            for s in (js, ts):
                s.submit(u, v)
        else:
            a = js.query(u, v)
            b = ts.query(u, v)
            np.testing.assert_array_equal(np.asarray(a), b)
            np.testing.assert_array_equal(
                b, reach_oracle(n, np.asarray(es), np.asarray(ed))[u, v])
        ns = rng.integers(0, n, 20).astype(np.int32)
        nd = rng.integers(0, n, 20).astype(np.int32)
        js.insert(ns, nd)
        ts.insert(ns, nd)
        if r == 1:
            a, = js.flush()
            b, = ts.flush()
            np.testing.assert_array_equal(np.asarray(a), b)
            np.testing.assert_array_equal(
                b, reach_oracle(n, np.asarray(es), np.asarray(ed))[u, v])
        es += list(ns)
        ed += list(nd)
    for key in ("queries", "label_answered", "bfs_answered", "inserts",
                "flushes"):
        assert getattr(ts.stats, key) == getattr(js.stats, key), key
    for key in _STATS:
        assert getattr(ts.engine.stats, key) == \
            getattr(js.engine.stats, key), key
    assert ts.engine_stats()["epoch"] == js.engine_stats()["epoch"] == 3
    # a delete, then a query on the dirty index, as the reference serves it
    js.delete(src[:30], dst[:30])
    ts.delete(src[:30], dst[:30])
    u = rng.integers(0, n, 400).astype(np.int32)
    v = rng.integers(0, n, 400).astype(np.int32)
    a = js.query(u, v)
    b = ts.query(u, v)
    np.testing.assert_array_equal(np.asarray(a), b)
    es, ed = np.asarray(es), np.asarray(ed)
    dead = np.isin(es.astype(np.int64) * n + ed,
                   src[:30].astype(np.int64) * n + dst[:30])
    np.testing.assert_array_equal(b, reach_oracle(n, es[~dead],
                                                  ed[~dead])[u, v])
    # the duplicate pairs of this power-law graph die too: the tombstones
    # pass the default rebuild_dead_ratio and the query ran after the lazy
    # rebuild on both sides
    for key in ("dirty", "rebuild_due", "last_rebuild"):
        assert ts.engine_stats()[key] == js.engine_stats()[key], key


def test_numpy_round_trips_with_jax_index():
    n = 150
    src, dst = _graph("power_law", n, 450, 11)
    jidx = JIndex.build(JG.make_graph(src, dst, n, m_cap=500), n_cap=n,
                        k=24, k_prime=16, max_iters=64)
    jidx = jidx.insert_edges(np.array([3, 9], np.int32),
                             np.array([7, 140], np.int32), max_iters=64)
    # JAX-built index -> port: same fields, same answers
    tidx = TIndex.from_numpy(jax_to_numpy(jidx), device=CPU)
    assert_same_index(jidx, tidx)
    rng = np.random.default_rng(0)
    u = rng.integers(0, n, 500).astype(np.int32)
    v = rng.integers(0, n, 500).astype(np.int32)
    np.testing.assert_array_equal(tidx.query(u, v, bfs_chunk=32,
                                             max_iters=64),
                                  np.asarray(jidx.query(u, v, bfs_chunk=32,
                                                        max_iters=64)))
    # port-built/updated index -> JAX: same fields, same answers
    tidx = tidx.insert_edges(np.array([40], np.int32),
                             np.array([2], np.int32), max_iters=64)
    jback = numpy_to_jax(tidx.to_numpy())
    assert_same_index(jback, tidx)
    np.testing.assert_array_equal(
        np.asarray(jback.query(u, v, bfs_chunk=32, max_iters=64)),
        tidx.query(u, v, bfs_chunk=32, max_iters=64))
    # words that disagree with their planes are refused
    bad = jax_to_numpy(jidx)
    bad["packed.dl_in"] = bad["packed.dl_in"] ^ np.uint32(1)
    with pytest.raises(ValueError, match="packed.dl_in"):
        TIndex.from_numpy(bad, device=CPU)


def test_dirty_jax_index_served_by_port_engine():
    """A reference index carrying tombstones (labels not rebuilt) serves
    through the port's tombstone-cutoff path with the reference's answers."""
    n = 150
    src, dst = _graph("random", n, 400, 5)
    jidx = JIndex.build(JG.make_graph(src, dst, n), n_cap=n, k=16,
                        k_prime=16, max_iters=64)
    jidx = jidx.delete_edges(src[:60], dst[:60])
    tidx = TIndex.from_numpy(jax_to_numpy(jidx), device=CPU)
    assert tidx.is_dirty
    rng = np.random.default_rng(3)
    u = rng.integers(0, n, 400).astype(np.int32)
    v = rng.integers(0, n, 400).astype(np.int32)
    live = np.asarray(JG.edge_mask(jidx.graph))[:src.size]
    R = reach_oracle(n, src[live], dst[live])
    want = np.asarray(jidx.query(u, v, bfs_chunk=32, max_iters=64))
    np.testing.assert_array_equal(want, R[u, v])
    for driver in ("engine", "host"):
        got = tidx.query(u, v, bfs_chunk=32, max_iters=64, driver=driver)
        np.testing.assert_array_equal(got, want)
    eng = TEngine(tidx, bfs_chunk=32, max_iters=64, bfs_kernel=True)
    np.testing.assert_array_equal(eng.query(u, v), R[u, v])


def test_saturation_contract_matches():
    n = 80
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)          # one long chain
    from repro_torch.core.dbl import (LabelSaturationError,
                                      LabelSaturationWarning)
    g = t_make_graph(src, dst, n, m_cap=n + 8, device=CPU)
    with pytest.raises(LabelSaturationError):
        TIndex.build(g, n_cap=n, k=4, k_prime=8, max_iters=8,
                     check="raise", device=CPU)
    with pytest.warns(LabelSaturationWarning):
        TIndex.build(g, n_cap=n, k=4, k_prime=8, max_iters=8, device=CPU)
    idx = TIndex.build(g, n_cap=n, k=4, k_prime=8, max_iters=8,
                       check="defer", device=CPU)
    jidx = JIndex.build(JG.make_graph(src, dst, n, m_cap=n + 8), n_cap=n,
                        k=4, k_prime=8, max_iters=8, check="defer")
    assert idx.saturated and bool(jidx.saturated)
    assert_same_index(jidx, idx)
    ok = TIndex.build(g, n_cap=n, k=4, k_prime=8, max_iters=n + 2,
                      check="raise", device=CPU)
    assert not ok.saturated
    # the engine defers an insert's saturation to the next flush
    eng = TEngine(ok, bfs_chunk=16, max_iters=3)
    eng.insert(np.array([n - 1], np.int32), np.array([0], np.int32))
    assert eng.index.saturated
    with pytest.warns(LabelSaturationWarning):
        eng.flush([eng.submit(eng.index, [0], [1])])
    assert eng.stats.saturation_events == 1


def test_engine_flush_policies():
    n = 200
    _, tidx, src, dst = _pair("dag_like", n=n, m=420, seed=3, k=16, kp=8)
    rng = np.random.default_rng(8)
    batches = [[rng.integers(0, n, 300).astype(np.int32) for _ in range(2)]
               for _ in range(4)]
    R = reach_oracle(n, src, dst)
    # watermark: resolves once the pooled residue reaches the mark
    eng = TEngine(tidx, bfs_chunk=32, max_iters=64,
                  flush_policy="watermark", flush_watermark=8)
    pends = [eng.submit(tidx, u, v) for u, v in batches]
    assert eng.stats.policy_flushes >= 1
    assert any(p._result is not None for p in pends)
    for p, (u, v) in zip(pends, batches):
        np.testing.assert_array_equal(p.resolve(), R[u, v])
    # deadline: a poll after the deadline flushes without new traffic
    now = [0.0]
    eng = TEngine(tidx, bfs_chunk=32, max_iters=64,
                  flush_policy="deadline", flush_deadline_ms=5.0)
    eng._clock = lambda: now[0]
    p = eng.submit(tidx, *batches[0])
    assert not eng.maybe_flush() and p._result is None
    now[0] = 0.01
    assert eng.maybe_flush() and p._result is not None
    np.testing.assert_array_equal(p._result, R[batches[0][0],
                                                batches[0][1]])
    with pytest.raises(ValueError):
        TEngine(tidx, flush_policy="sometimes")
    # packed planes and frontiers construct; mesh= takes a query mesh and
    # refuses anything else by its type
    for kw in (dict(plane_repr="packed"), dict(frontier_dtype="packed")):
        TEngine(tidx, **kw)
    with pytest.raises(TypeError, match="query_mesh"):
        TEngine(tidx, mesh=object())
    with pytest.raises(ValueError):
        TEngine(tidx, plane_repr="words")
