"""Word planes in the port: the bitset segment-OR algebra, the packed OR
fixpoint, the packed BFS frontier and the packed lifecycle and engine,
held bitwise against the JAX package (``plane_repr="packed"``,
``frontier_dtype="packed"``) and against the port's own bool path."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DBLIndex as JIndex
from repro.core import bitset as JB
from repro.core import graph as JG
from repro.core import propagate as JP
from repro.core import query as JQ
from repro.core import update as JU
from repro.serve.engine import QueryEngine as JEngine
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import bitset as TB
from repro_torch.core import graph as TG
from repro_torch.core import propagate as TP
from repro_torch.core import query as TQ
from repro_torch.core import update as TU
from repro_torch.core.dbl import LabelSaturationWarning
from repro_torch.serve.engine import QueryEngine as TEngine
from tests.conftest import reach_oracle
from tests.test_torch_slice import jax_to_numpy

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, msg=""):
    """Bitwise equality; int32 words are compared as the uint32 bits."""
    a, b = _np(a), _np(b)
    if a.dtype == np.int32 and b.dtype == np.uint32:
        a = a.view(np.uint32)
    if b.dtype == np.int32 and a.dtype == np.uint32:
        b = b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same_index(jidx, tidx):
    """Every field of the reference's index, the "il" ones included, equal
    to the port's ``to_numpy``."""
    want = jax_to_numpy(jidx)
    if jidx.il_in is not None:
        want.update(il_in=np.asarray(jidx.il_in),
                    il_out=np.asarray(jidx.il_out),
                    il_seed=np.asarray(jidx.il_seed))
    got = tidx.to_numpy()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


# ------------------------------------------------------- bitset algebra
# the reference's helpers as its callers run them, under jit (eager, the
# associative scan compiles op by op)
_J_SCATTER = jax.jit(JB.scatter_or)
_J_SORTED = jax.jit(JB.sorted_segment_or, static_argnums=2)
_J_FLAGS = jax.jit(JB.segment_or_flags, static_argnums=4)
_J_SEEDS = jax.jit(JU.insert_seeds,
                   static_argnames=("n_cap", "reverse", "plane_repr"))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64])
def test_bitset_helpers_match(k):
    rng = np.random.default_rng(k)
    n, b = 30, 40
    base = rng.random((n, k)) < 0.3
    vals = rng.random((b, k)) < 0.3
    vals[0, k - 1] = True                  # the top lane of the last word
    if k >= 32:
        vals[1, 31] = base[2, 31] = True   # lane 31: the int32 sign bit
    at = rng.integers(0, n + 5, b).astype(np.int32)   # some out of range
    at[3] = at[4]                                      # a duplicate
    jb, jv = JB.pack(jnp.asarray(base)), JB.pack(jnp.asarray(vals))
    tb, tv = TB.pack(_t(base)), TB.pack(_t(vals))
    _eq(tb, jb)
    _eq(TB.union(tb, tv[:n]), JB.union(jb, jv[:n]))
    got = TB.scatter_or(tb, tv, _t(at))
    _eq(got, _J_SCATTER(jb, jv, jnp.asarray(at)))
    want = base.copy()
    for i in range(b):
        if at[i] < n:
            want[at[i]] |= vals[i]
    _eq(TB.unpack(got, k), want)
    # empty batch, empty segments and the sorted front doors
    _eq(TB.scatter_or(tb, tv[:0], _t(at[:0])), jb)
    order = np.argsort(at, kind="stable")
    ids = at[order]
    _eq(TB.sorted_segment_or(tv[order], _t(ids), n),
        _J_SORTED(jv[order], jnp.asarray(ids), n))
    _eq(TB.sorted_segment_or(tv[:0], _t(ids[:0]), n),
        JB.sorted_segment_or(jv[:0], jnp.asarray(ids[:0]), n))
    edge = ids[1:] != ids[:-1]
    start = np.concatenate([[True], edge])
    tail = np.concatenate([edge, [True]])
    _eq(TB.segment_or_flags(tv[order], _t(start), _t(tail), _t(ids), n),
        _J_FLAGS(jv[order], jnp.asarray(start), jnp.asarray(tail),
                 jnp.asarray(ids), n))
    # popcount and rows_changed ignore pad bits forced high
    jm, tm = JB.pad_mask(k), TB.pad_mask(k)
    _eq(tm, jm)
    _eq(TB.popcount(tb), JB.popcount(jb))
    _eq(TB.popcount(tb | ~tm, k=k), JB.popcount(jb | ~jm, k=k))
    _eq(TB.popcount(tb | ~tm, k=k), base.sum(-1))
    _eq(TB.rows_changed(tb, tb | ~tm, k=k),
        JB.rows_changed(jb, jb | ~jm, k=k))
    _eq(TB.rows_changed(tb, tb | ~tm), JB.rows_changed(jb, jb | ~jm))
    idx = np.array([0, k - 1, min(31, k - 1), k // 2], np.int32)
    _eq(TB.bit_row(k, _t(idx)), JB.bit_row(k, jnp.asarray(idx)))


# ----------------------------------------------------- packed fixpoint
def _edges(rng, n, m, extra=8):
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    live = rng.random(m + extra) < 0.85
    live[m:] = False
    return (np.pad(src, (0, extra)), np.pad(dst, (0, extra)), live)


@pytest.mark.parametrize("k,seed", [(1, 0), (33, 1), (64, 2)])
def test_propagate_packed_matches(k, seed):
    rng = np.random.default_rng(seed)
    n = 40
    src, dst, live = _edges(rng, n, 120)
    plane = np.zeros((n, k), np.uint8)
    seeds = rng.integers(0, n, min(k, n))
    plane[seeds, np.arange(seeds.size) % k] = 1
    frontier = plane.any(1)
    for reverse in (False, True):
        jout, jit = JP.propagate(
            jnp.asarray(plane), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(live), jnp.asarray(frontier), n_cap=n, max_iters=64,
            reverse=reverse, plane_repr="packed")
        outs = [TP.propagate(_t(plane), _t(src), _t(dst), _t(live),
                             _t(frontier), n_cap=n, max_iters=64,
                             reverse=reverse, plane_repr=r)
                for r in ("packed", "bool")]
        for out, it in outs:
            _eq(out, jout)
            assert it == int(jit)
        assert outs[0][0].dtype == torch.uint8


def test_propagate_packed_truncation_and_rejections():
    n = 12
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    live = np.ones(n - 1, bool)
    plane = np.zeros((n, 5), np.uint8)
    plane[0, 0] = 1
    frontier = plane.any(1)
    for mi in (3, n + 2):
        jout, jit = JP.propagate(
            jnp.asarray(plane), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(live), jnp.asarray(frontier), n_cap=n, max_iters=mi,
            plane_repr="packed")
        tout, tit = TP.propagate(_t(plane), _t(src), _t(dst), _t(live),
                                 _t(frontier), n_cap=n, max_iters=mi,
                                 plane_repr="packed")
        _eq(tout, jout)
        assert tit == int(jit) == (mi + 1 if mi == 3 else n)
    e = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="OR monoid only"):
        TP.propagate(torch.zeros((4, 3), dtype=torch.int32), e, e,
                     torch.ones(2, dtype=torch.bool),
                     torch.zeros(4, dtype=torch.bool), n_cap=4,
                     monoid="min", plane_repr="packed")
    for bad in (lambda: TP.check_plane_repr("zip"),
                lambda: TIndex.build(TG.make_graph(src, dst, n, device=CPU),
                                     n_cap=n, k=2, k_prime=2,
                                     plane_repr="zip", device=CPU)):
        with pytest.raises(ValueError, match="plane_repr"):
            bad()


@pytest.mark.parametrize("k", [33, 64])
def test_seed_scatter_packed_matches(k):
    rng = np.random.default_rng(k)
    n, b = 25, 12
    base = (rng.random((n, k)) < 0.3).astype(np.uint8)
    ns = rng.integers(0, n, b).astype(np.int32)
    nd = rng.integers(0, n, b).astype(np.int32)
    nd[1] = nd[0]
    for reverse in (False, True):
        js, jf = _J_SEEDS(jnp.asarray(base), jnp.asarray(ns),
                          jnp.asarray(nd), n_cap=n, reverse=reverse,
                          plane_repr="packed")
        for r in ("packed", "bool"):
            for inplace in (False, True):
                plane = _t(base.copy())
                ts, tf = TU.insert_seeds(plane, _t(ns), _t(nd), n_cap=n,
                                         reverse=reverse, plane_repr=r,
                                         inplace=inplace)
                _eq(ts, js)
                _eq(tf, jf)
                _eq(plane, js if inplace else base)


# ----------------------------------------------------- packed BFS lanes
# one graph shape for the BFS, lifecycle and engine cases, so that the
# reference compiles its programs once for the module
N, M, M_CAP = 150, 500, 1024
KW = dict(n_cap=N, k=20, k_prime=13, max_iters=64)
IL_FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=3)


def _graph(rng):
    return (rng.integers(0, N, M).astype(np.int32),
            rng.integers(0, N, M).astype(np.int32))


@pytest.mark.parametrize("qc,clean,il", [(37, True, False),
                                         (64, False, False),
                                         (37, True, True)])
def test_pruned_bfs_packed_matches(qc, clean, il):
    rng = np.random.default_rng(qc + clean)
    src, dst = _graph(rng)
    fam = IL_FAM if il else {}
    jidx = JIndex.build(JG.make_graph(src, dst, N, m_cap=M_CAP), **KW, **fam)
    tidx = TIndex.build(TG.make_graph(src, dst, N, m_cap=M_CAP, device=CPU),
                        device=CPU, **KW, **fam)
    n, m = N, M
    ns = rng.integers(0, n, 30).astype(np.int32)
    nd = rng.integers(0, n, 30).astype(np.int32)
    jidx = jidx.insert_edges(ns, nd, max_iters=64)
    tidx = tidx.insert_edges(ns, nd, max_iters=64)
    u = rng.integers(0, n, qc).astype(np.int32)
    v = rng.integers(0, n, qc).astype(np.int32)
    u[::9] = n                                   # dead lanes
    cut = np.where(rng.random(qc) < 0.4, m - 5, 2 ** 31 - 1).astype(np.int32)
    for m_cut in (None, cut):
        want = JQ.pruned_bfs(
            jidx.graph, jidx.packed, jnp.asarray(u), jnp.asarray(v),
            m_cut=None if m_cut is None else jnp.asarray(m_cut),
            dl_clean=jnp.asarray(clean), il=jidx.il, n_cap=n, max_iters=64,
            frontier_dtype="packed")
        for fd in ("packed", "int8"):
            got = TQ.pruned_bfs(
                tidx.graph, tidx.packed, _t(u), _t(v),
                m_cut=None if m_cut is None else _t(m_cut), dl_clean=clean,
                il=tidx.il, n_cap=n, max_iters=64, frontier_dtype=fd)
            _eq(got, want, f"{fd} m_cut={m_cut is not None}")


# ------------------------------------------------------ the lifecycle
def test_packed_lifecycle_matches_bool_and_jax():
    """build -> insert -> insert -> delete -> delta / full / auto rebuild,
    packed against bool in the port and packed in the reference, every
    field bitwise at every step (k, k' not multiples of 32)."""
    rng = np.random.default_rng(7)
    n, kw = N, KW
    src, dst = _graph(rng)
    jp = JIndex.build(JG.make_graph(src, dst, n, m_cap=M_CAP),
                      plane_repr="packed", **kw)
    tg = TG.make_graph(src, dst, n, m_cap=M_CAP, device=CPU)
    tp = TIndex.build(tg, plane_repr="packed", device=CPU, **kw)
    tb = TIndex.build(tg, device=CPU, **kw)

    def check(stage):
        assert_same_index(jp, tp)
        for f in ("dl_in", "dl_out", "bl_in", "bl_out"):
            _eq(getattr(tp, f), getattr(tb, f), f"{stage}:{f}")
        assert tp.saturated == tb.saturated

    check("build")
    for step in range(2):
        es = rng.integers(0, n, 25).astype(np.int32)
        ed = rng.integers(0, n, 25).astype(np.int32)
        jp = jp.insert_edges(es, ed, max_iters=64, plane_repr="packed")
        tp = tp.insert_edges(es, ed, max_iters=64, plane_repr="packed")
        tb = tb.insert_edges(es, ed, max_iters=64)
        check(f"insert{step}")
    jp = jp.delete_edges(src[:40], dst[:40])
    tp = tp.delete_edges(src[:40], dst[:40])
    tb = tb.delete_edges(src[:40], dst[:40])
    for mode in ("delta", "full", "auto"):
        jr, jinfo = jp.rebuild_info(mode=mode, max_iters=64,
                                    plane_repr="packed")
        tr, tinfo = tp.rebuild_info(mode=mode, max_iters=64,
                                    plane_repr="packed")
        br, binfo = tb.rebuild_info(mode=mode, max_iters=64)
        assert tinfo == jinfo == binfo
        assert_same_index(jr, tr)
        for f in ("dl_in", "dl_out", "bl_in", "bl_out"):
            _eq(getattr(tr, f), getattr(br, f), f"{mode}:{f}")


def test_packed_build_saturation_warns_like_bool():
    n = 20
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    g = TG.make_graph(src, dst, n, m_cap=32, device=CPU)
    for r in ("bool", "packed"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            idx = TIndex.build(g, n_cap=n, k=4, k_prime=4, max_iters=2,
                               plane_repr=r, device=CPU)
        assert idx.saturated, r
        assert any(issubclass(x.category, LabelSaturationWarning)
                   for x in w), r


# ------------------------------------------------------- the engine
_STATS = ("queries", "rho", "bfs_dispatches", "batches", "inserts",
          "deletes", "rebuilds", "delta_rebuilds", "stale_lanes", "flushes",
          "prune_hits")


@pytest.mark.parametrize("il", [False, True])
def test_engine_packed_stream_matches_jax(il):
    """A packed engine (planes, BFS frontier, int32 verdict stores) over a
    submit/insert/flush, delete and rebuild stream answers as the
    reference's packed engine and the port's default engine, with equal
    stats and rebuild reports."""
    rng = np.random.default_rng(17 + il)
    n = N
    src, dst = _graph(rng)
    kw = {**KW, **(IL_FAM if il else {})}
    pk = dict(max_iters=64, plane_repr="packed", frontier_dtype="packed",
              out_dtype="int32", bfs_chunk=32)
    je = JEngine(JIndex.build(JG.make_graph(src, dst, n, m_cap=M_CAP),
                              plane_repr="packed", **kw), **pk)
    tg = TG.make_graph(src, dst, n, m_cap=M_CAP, device=CPU)
    te = TEngine(TIndex.build(tg, plane_repr="packed", device=CPU, **kw),
                 bfs_kernel=True, **pk)
    td = TEngine(TIndex.build(tg, device=CPU, **kw), max_iters=64,
                 bfs_chunk=32)
    engines = (je, te, td)
    pend = []
    for step in range(3):
        qu = rng.integers(0, n, 120).astype(np.int32)
        qv = rng.integers(0, n, 120).astype(np.int32)
        pend.append([e.submit(e.index, qu, qv) for e in engines])
        es = rng.integers(0, n, 20).astype(np.int32)
        ed = rng.integers(0, n, 20).astype(np.int32)
        for e in engines:
            e.insert(es, ed)
    for ps in pend:
        want = ps[0].resolve()
        for p in ps[1:]:
            np.testing.assert_array_equal(p.resolve(), want)
    for e in engines:
        e.delete(src[:10], dst[:10])
    qu = rng.integers(0, n, 90).astype(np.int32)
    qv = rng.integers(0, n, 90).astype(np.int32)
    want = je.query(qu, qv)
    for e in (te, td):
        np.testing.assert_array_equal(e.query(qu, qv), want)
    for e in engines:
        e.rebuild(mode="delta")
    assert te.last_rebuild_info == je.last_rebuild_info \
        == td.last_rebuild_info
    assert te.last_rebuild_info["mode"] == "delta"
    assert_same_index(je.index, te.index)
    want = je.query(qu, qv)
    for e in (te, td):
        np.testing.assert_array_equal(e.query(qu, qv), want)
    js, ts = je.stats.as_dict(), te.stats.as_dict()
    assert {f: ts[f] for f in _STATS} == {f: js[f] for f in _STATS}
