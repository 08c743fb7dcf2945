"""Fully-dynamic serving in the port: the deletion and rebuild surface of
graph, propagate, update, labels, query and DBLIndex, the streaming
engine over a query/insert/delete/rebuild stream and the server's lazy
rebuild, held bitwise against the JAX package and the dense oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbl as JD
from repro.core import graph as JG
from repro.core import labels as JL
from repro.core import propagate as JP
from repro.core import query as JQ
from repro.core import select as JS
from repro.core import update as JU
from repro.serve.engine import QueryEngine as JEngine
from repro.serve.reach_server import ReachabilityServer as JServer
from repro_torch.core import dbl as TD
from repro_torch.core import graph as TG
from repro_torch.core import labels as TL
from repro_torch.core import propagate as TP
from repro_torch.core import query as TQ
from repro_torch.core import select as TS
from repro_torch.core import update as TU
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer as TServer
from tests.conftest import reach_oracle
from tests.test_torch_slice import _pair, assert_same_index

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def _graphs(rng, n, m, m_cap):
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return (src, dst, JG.make_graph(src, dst, n, m_cap=m_cap),
            TG.make_graph(src, dst, n, m_cap=m_cap, device=CPU))


def _same_graph(gj, gt):
    for f in ("src", "dst", "n", "del_at"):
        _eq(getattr(gj, f), getattr(gt, f), f)
    assert int(gj.m) == gt.m and int(gj.del_epoch) == gt.del_epoch


def _live(src, dst, dead_src, dead_dst, n):
    """The edges that survive deleting the pairs (all duplicates die)."""
    src, dst = np.asarray(src), np.asarray(dst)
    dead = np.isin(src.astype(np.int64) * n + dst,
                   np.asarray(dead_src).astype(np.int64) * n
                   + np.asarray(dead_dst))
    return src[~dead], dst[~dead]


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_delete_compact_and_counts_match(seed):
    rng = np.random.default_rng(seed)
    n, m = 30, 90
    src, dst, gj, gt = _graphs(rng, n, m, m + 10)
    src[5], dst[5] = src[4], dst[4]        # a duplicate pair dies with it
    gj = JG.make_graph(src, dst, n, m_cap=m + 10)
    gt = TG.make_graph(src, dst, n, m_cap=m + 10, device=CPU)
    for batch in range(3):
        pick = rng.choice(m, 6, replace=False)
        ds = np.concatenate([src[pick], [n + 3]]).astype(np.int32)
        dd = np.concatenate([dst[pick], [0]]).astype(np.int32)  # no match
        gj, ej = JU.delete_and_mark(gj, jnp.asarray(ds), jnp.asarray(dd),
                                    jnp.int32(7 + batch))
        gt, et = TU.delete_and_mark(gt, ds, dd, 7 + batch)
        assert int(ej) == et == 8 + batch
        _same_graph(gj, gt)
        for d in range(batch + 1):
            _eq(JG.deleted_since(gj, d), TG.deleted_since(gt, d))
        assert int(JG.live_edge_count(gj)) == int(TG.live_edge_count(gt))
        assert int(JG.dead_edge_count(gj)) == int(TG.dead_edge_count(gt))
        if batch == 1:   # inserts after a delete append live slots
            ns = rng.integers(0, n, 4).astype(np.int32)
            nd = rng.integers(0, n, 4).astype(np.int32)
            gj = JG.insert_edges(gj, jnp.asarray(ns), jnp.asarray(nd))
            gt = TG.insert_edges(gt, torch.from_numpy(ns),
                                 torch.from_numpy(nd))
    _same_graph(JG.compact(gj), TG.compact(gt))


@pytest.mark.parametrize("reverse", [False, True])
def test_reach_mask_push_boundary_and_host_reach_match(reverse):
    rng = np.random.default_rng(11 + reverse)
    n, m = 70, 160
    src, dst, gj, gt = _graphs(rng, n, m, m + 8)
    live = rng.random(m + 8) < 0.8
    live[m:] = False
    seeds = rng.random(n) < 0.05
    mj, itj = JP.reach_mask(gj.src, gj.dst, jnp.asarray(live),
                            jnp.asarray(seeds), n_cap=n, max_iters=n,
                            reverse=reverse)
    mt, itt = TP.reach_mask(gt.src, gt.dst, torch.from_numpy(live),
                            torch.from_numpy(seeds), n_cap=n, max_iters=n,
                            reverse=reverse)
    _eq(mj, mt)
    assert int(itj) == itt
    s, d = (gt.dst, gt.src) if reverse else (gt.src, gt.dst)
    _eq(TD._host_reach(s.numpy(), d.numpy(), live, seeds), mt)
    _eq(JD._host_reach(s.numpy(), d.numpy(), live, seeds), mt)
    dirty = rng.random(n) < 0.2
    _eq(JP.push_boundary(gj.src, gj.dst, jnp.asarray(live),
                         jnp.asarray(dirty), n_cap=n, reverse=reverse),
        TP.push_boundary(gt.src, gt.dst, torch.from_numpy(live),
                         torch.from_numpy(dirty), n_cap=n, reverse=reverse))


@pytest.mark.parametrize("plane_repr", ["bool", "packed"])
@pytest.mark.parametrize("reverse", [False, True])
def test_reach_mask_push_boundary_plane_repr_match(reverse, plane_repr):
    """Both plane representations, on the path 0->1->2->3 at n_cap 8 and
    on a random graph, bitwise against the reference."""
    path = np.array([0, 1, 2], np.int32), np.array([1, 2, 3], np.int32)
    rng = np.random.default_rng(21)
    rand = (rng.integers(0, 40, 120).astype(np.int32),
            rng.integers(0, 40, 120).astype(np.int32))
    for (src, dst), n_cap in ((path, 8), (rand, 40)):
        live = np.ones(src.size, bool) if n_cap == 8 \
            else rng.random(src.size) < 0.8
        seeds = np.zeros(n_cap, bool)
        dirty = np.zeros(n_cap, bool)
        if n_cap == 8:
            seeds[3 if reverse else 0] = True
            dirty[0 if reverse else 3] = True
        else:
            seeds[rng.choice(n_cap, 3, replace=False)] = True
            dirty[rng.choice(n_cap, 8, replace=False)] = True
        gj = JG.make_graph(src, dst, n_cap)
        gt = TG.make_graph(src, dst, n_cap, device=CPU)
        kw = dict(n_cap=n_cap, reverse=reverse, plane_repr=plane_repr)
        mj, itj = JP.reach_mask(gj.src, gj.dst, jnp.asarray(live),
                                jnp.asarray(seeds), max_iters=n_cap, **kw)
        mt, itt = TP.reach_mask(gt.src, gt.dst, torch.from_numpy(live),
                                torch.from_numpy(seeds), max_iters=n_cap,
                                **kw)
        _eq(mj, mt)
        assert int(itj) == itt
        bj = JP.push_boundary(gj.src, gj.dst, jnp.asarray(live),
                              jnp.asarray(dirty), **kw)
        bt = TP.push_boundary(gt.src, gt.dst, torch.from_numpy(live),
                              torch.from_numpy(dirty), **kw)
        _eq(bj, bt)
        if n_cap == 8:
            want_mask = [0, 0, 0, 0, 0, 0, 0, 0]
            want_mask[:4] = [1, 1, 1, 1]
            want_push = [0] * 8
            want_push[1 if reverse else 2] = 1
            _eq(mt.to(torch.int64), want_mask)
            _eq(bt.to(torch.int64), want_push)
    with pytest.raises(ValueError):
        TP.push_boundary(gt.src, gt.dst, torch.from_numpy(live),
                         torch.from_numpy(dirty), n_cap=40,
                         plane_repr="words")


def test_delta_plane_state_matches():
    rng = np.random.default_rng(5)
    n, m, k, kp = 60, 150, 8, 16
    src, dst, gj, gt = _graphs(rng, n, m, m + 8)
    planes = [(rng.random((n, kk)) < 0.3).astype(np.uint8)
              for kk in (k, k, kp, kp)]
    old_lm = rng.choice(n, k, replace=False).astype(np.int32)
    new_lm = old_lm.copy()
    new_lm[[1, 4]] = new_lm[[4, 1]]                 # a rank swap
    new_lm[6] = next(x for x in range(n) if x not in old_lm)   # a new one
    masks = [rng.random(n) < 0.3 for _ in range(4)]
    dirty = [rng.random(n) < 0.2 for _ in range(2)]
    j = JL.delta_plane_state(
        gj, *(jnp.asarray(p) for p in planes), jnp.asarray(old_lm),
        jnp.asarray(new_lm), *(jnp.asarray(x) for x in masks),
        *(jnp.asarray(x) for x in dirty), n_cap=n, k=k, k_prime=kp)
    t = TL.delta_plane_state(
        gt, *(torch.from_numpy(p) for p in planes), torch.from_numpy(old_lm),
        torch.from_numpy(new_lm), *(torch.from_numpy(x) for x in masks),
        *(torch.from_numpy(x) for x in dirty), n_cap=n, k=k, k_prime=kp)
    assert len(j) == len(t) == 8
    for a, b in zip(j, t):
        _eq(a, b)
    for a, b in zip(JL.realign_landmarks(*(jnp.asarray(p) for p in planes[:2]),
                                         jnp.asarray(old_lm),
                                         jnp.asarray(new_lm)),
                    TL.realign_landmarks(*(torch.from_numpy(p)
                                           for p in planes[:2]),
                                         torch.from_numpy(old_lm),
                                         torch.from_numpy(new_lm))):
        _eq(a, b)
    _eq(JL.bucket_churn(jnp.asarray(masks[0]), jnp.asarray(masks[2]),
                        k_prime=kp),
        TL.bucket_churn(torch.from_numpy(masks[0]),
                        torch.from_numpy(masks[2]), k_prime=kp))


def test_dirty_asof_and_label_stats_match():
    jidx, tidx, _, _ = _pair("power_law", n=100, m=320, seed=4)
    rng = np.random.default_rng(6)
    u = rng.integers(0, 100, 300).astype(np.int32)
    v = rng.integers(0, 100, 300).astype(np.int32)
    v[::9] = u[::9]
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    _eq(JQ.dirty_label_verdicts(jidx.packed, ju, jv),
        TQ.dirty_label_verdicts(tidx.packed, tu, tv))
    verd = TQ.label_verdicts(tidx.packed, tu, tv)
    m_cut = rng.integers(300, 340, 300).astype(np.int32)
    _eq(JQ.asof_verdicts(jnp.asarray(verd.numpy()), ju, jv,
                         jnp.asarray(m_cut), jnp.int32(320)),
        TQ.asof_verdicts(verd, tu, tv, torch.from_numpy(m_cut), 320))
    js = JQ.label_stats(jidx.packed, ju, jv)
    ts = TQ.label_stats(tidx.packed, tu, tv)
    assert set(js) == set(ts)
    for key in js:
        _eq(js[key], ts[key], key)


def _no_churn(src, dst, n, count, spare):
    """``count`` edge slots whose pairs can die without changing a leaf
    mask or the top landmarks: both endpoints keep a live edge on that
    side, and neither is among the ``spare`` highest-degree vertices."""
    out_deg = np.bincount(src, minlength=n)
    in_deg = np.bincount(dst, minlength=n)
    top = set(np.argsort(-(out_deg * in_deg), kind="stable")[:spare])
    pairs = src.astype(np.int64) * n + dst
    sel = []
    for i in range(src.size):
        a, b = int(src[i]), int(dst[i])
        mult = int((pairs == pairs[i]).sum())
        if a in top or b in top or out_deg[a] <= mult or in_deg[b] <= mult \
                or pairs[i] in pairs[sel]:
            continue
        out_deg[a] -= mult
        in_deg[b] -= mult
        sel.append(i)
        if len(sel) == count:
            return np.array(sel)
    raise AssertionError("graph too small for a churn-free delete")


def _dynamic_pair(kind, deletes, churn=True):
    """A (JAX, port) index pair after an insert and a delete batch: random
    pairs, or the tail edges of a layered DAG (a partial closure, so the
    delta path runs); ``churn=False`` skips the insert (which can turn a
    leaf into an inner vertex) and picks pairs that leave every seed set
    as it was, so the delta pass relaxes only edges into the dirty
    region."""
    n = 120
    jidx, tidx, src, dst = _pair(kind, n=n, m=400, seed=2)
    rng = np.random.default_rng(0)
    if churn:
        ns = rng.integers(0, n, 10).astype(np.int32)
        nd = rng.integers(0, n, 10).astype(np.int32)
        jidx = jidx.insert_edges(ns, nd, max_iters=64)
        tidx = tidx.insert_edges(ns, nd, max_iters=64)
    if not churn:
        sel = _no_churn(src, dst, n, deletes, 20)
    elif kind == "dag_like":
        sel = np.arange(400 - deletes, 400)
    else:
        sel = rng.choice(400, deletes, replace=False)
    jidx = jidx.delete_edges(src[sel], dst[sel])
    tidx = tidx.delete_edges(src[sel], dst[sel])
    assert_same_index(jidx, tidx)
    assert tidx.is_dirty
    return jidx, tidx


@pytest.mark.parametrize("kind,mode,churn,kw", [
    ("power_law", "full", True, {}),
    ("power_law", "delta", True, {}),
    ("dag_like", "auto", True, {}),
    ("dag_like", "delta", True, dict(compact=False)),
    ("random", "auto", True, dict(delta_threshold=0.0)),
    ("random", "delta", False, {}),
    ("dag_like", "auto", False, dict(compact=False)),
])
def test_rebuild_matches_reference(kind, mode, churn, kw):
    jidx, tidx = _dynamic_pair(kind, 12, churn)
    j2, ji = jidx.rebuild_info(mode=mode, max_iters=64, **kw)
    t2, ti = tidx.rebuild_info(mode=mode, max_iters=64, **kw)
    assert ti == ji
    if not churn:
        est = ti["estimate"]
        assert est["fresh_cols_fwd"] == est["fresh_cols_bwd"] == 0
        assert ti["mode"] == "delta"
    assert_same_index(j2, t2)
    assert not t2.is_dirty and t2.epoch == tidx.epoch + 1
    if mode != "full":
        # the delta path ends where a full rebuild ends, bit for bit
        full = tidx.rebuild(mode="full", max_iters=64,
                            compact=kw.get("compact", True))
        for f in ("dl_in", "dl_out", "bl_in", "bl_out", "landmarks",
                  "bl_sources", "bl_sinks"):
            _eq(getattr(full, f), getattr(t2, f), f)


def test_saturated_index_rebuilds_in_full():
    n = 150
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1                       # a path: the fixpoint needs n rounds
    kw = dict(n_cap=n, k=4, k_prime=8, max_iters=8, check="defer")
    jidx = JD.DBLIndex.build(JG.make_graph(src, dst, n, m_cap=n), **kw)
    tidx = TD.DBLIndex.build(TG.make_graph(src, dst, n, m_cap=n,
                                           device=CPU), device=CPU, **kw)
    assert tidx.saturated and bool(jidx.saturated)
    jidx = jidx.delete_edges(src[:3], dst[:3])
    tidx = tidx.delete_edges(src[:3], dst[:3])
    for mode in ("delta", "auto"):
        j2, ji = jidx.rebuild_info(mode=mode, max_iters=8, check="defer")
        t2, ti = tidx.rebuild_info(mode=mode, max_iters=8, check="defer")
        assert ti == ji == {"mode": "full", "reason": "saturated"}
        assert_same_index(j2, t2)


def test_landmark_selection_after_deletes_matches():
    jidx, tidx = _dynamic_pair("power_law", 40)
    _eq(JS.select_landmarks(jidx.graph, n_cap=120, k=16),
        TS.select_landmarks(tidx.graph, n_cap=120, k=16))


def test_streaming_engine_dynamic_stream_matches_reference():
    """Twin of the reference's streaming serving test: query -> insert ->
    delete -> query on the dirty index -> rebuild -> query."""
    from repro.graphs.generators import power_law
    n, m = 160, 700
    src, dst = power_law(n, m, seed=5)
    kw = dict(n_cap=n, k=8, k_prime=8, max_iters=64)
    jidx = JD.DBLIndex.build(JG.make_graph(src, dst, n, m_cap=m + 64), **kw)
    tidx = TD.DBLIndex.build(TG.make_graph(src, dst, n, m_cap=m + 64,
                                           device=CPU), device=CPU, **kw)
    ej = JEngine(jidx, bfs_chunk=64, max_iters=64,
                 backend="pallas-interpret", bfs_kernel=True,
                 streaming=True)
    et = TEngine(tidx, bfs_chunk=64, max_iters=64, bfs_kernel=True,
                 streaming=True)
    assert et.streaming and et.backend == "torch"
    rng = np.random.default_rng(31)
    es, ed = src, dst
    steps = ["query", "insert", "query", "insert", "delete", "query",
             ("rebuild", "delta"), "query", "delete", ("rebuild", "auto"),
             "query"]
    for step in steps:
        if step == "query":
            u = rng.integers(0, n, 200).astype(np.int32)
            v = rng.integers(0, n, 200).astype(np.int32)
            a = ej.query(u, v)
            b = et.query(u, v)
            np.testing.assert_array_equal(np.asarray(a), b)
            np.testing.assert_array_equal(b, reach_oracle(n, es, ed)[u, v])
        elif step == "insert":
            ns = rng.integers(0, n, 16).astype(np.int32)
            nd = rng.integers(0, n, 16).astype(np.int32)
            ej.insert(ns, nd)
            et.insert(ns, nd)
            es, ed = np.concatenate([es, ns]), np.concatenate([ed, nd])
        elif step == "delete":
            pick = rng.choice(es.size, 20, replace=False)
            ds, dd = es[pick], ed[pick]
            ej.delete(ds, dd)
            et.delete(ds, dd)
            es, ed = _live(es, ed, ds, dd, n)
            assert et.index.is_dirty
        else:
            ej.rebuild(mode=step[1])
            et.rebuild(mode=step[1])
            assert et.last_rebuild_info == ej.last_rebuild_info
            assert not et.index.is_dirty
        assert et.epoch == ej.epoch
    assert_same_index(ej.index, et.index)
    jd, td = ej.stats.as_dict(), et.stats.as_dict()
    for key in td:
        assert td[key] == jd[key], key
    assert td["deletes"] == 40 and td["rebuilds"] == 2


@pytest.mark.parametrize("mode", ["auto", "full"])
def test_server_lazy_rebuild_matches_reference(mode):
    n = 120
    jidx, tidx, src, dst = _pair("dag_like", n=n, m=400, seed=2)
    kw = dict(bfs_chunk=32, max_iters=64, rebuild_dead_ratio=0.02,
              rebuild_mode=mode)
    js, ts = JServer(jidx, **kw), TServer(tidx, **kw)
    rng = np.random.default_rng(12)
    es, ed = src, dst
    # tail-layer deletes: 4 stay under the 2 % ratio, 4 more cross it
    for lo, hi in ((396, 400), (392, 396)):
        u = rng.integers(0, n, 300).astype(np.int32)
        v = rng.integers(0, n, 300).astype(np.int32)
        for s in (js, ts):
            s.submit(u, v)
        for s in (js, ts):
            s.delete(src[lo:hi], dst[lo:hi])
        a, = js.flush()
        b, = ts.flush()
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, reach_oracle(n, es, ed)[u, v])
        es, ed = _live(es, ed, src[lo:hi], dst[lo:hi], n)
    # the second batch crossed the ratio: the rebuild ran at that flush
    jst, tst = js.engine_stats(), ts.engine_stats()
    for key in ("dirty", "rebuild_due", "rebuild_mode", "last_rebuild",
                "deletes", "rebuilds", "delta_rebuilds", "epoch"):
        assert tst[key] == jst[key], key
    assert tst["rebuilds"] == 1 and not tst["dirty"]
    u = rng.integers(0, n, 300).astype(np.int32)
    v = rng.integers(0, n, 300).astype(np.int32)
    b = ts.query(u, v)
    np.testing.assert_array_equal(np.asarray(js.query(u, v)), b)
    np.testing.assert_array_equal(b, reach_oracle(n, es, ed)[u, v])
    for key in ("queries", "label_answered", "bfs_answered", "deletes",
                "rebuilds", "delta_rebuilds", "flushes"):
        assert getattr(ts.stats, key) == getattr(js.stats, key), key
    assert_same_index(js.index, ts.index)
    with pytest.raises(ValueError):
        TServer(tidx, rebuild_dead_ratio=0.0)
    with pytest.raises(ValueError):
        TServer(tidx, rebuild_mode="sometimes")
