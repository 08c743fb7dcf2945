"""The label-family registry and the "il" interval family in the port:
registry errors, the threefry rank draw, the MIN fixpoints, the interval
prune's soundness and dirty gating, and the lifecycle, engine, server and
streaming fallback of an "il" index, held bitwise against the JAX package
and the dense reachability oracle."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DBLIndex as JIndex
from repro.core import families as JF
from repro.core import graph as JG
from repro.core import interval as JIL
from repro.core import propagate as JP
from repro.serve.engine import QueryEngine as JEngine
from repro.serve.reach_server import ReachabilityServer as JServer
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import families as TF
from repro_torch.core import graph as TG
from repro_torch.core import interval as TIL
from repro_torch.core import propagate as TP
from repro_torch.core import update as TU
from repro_torch.kernels.dbl_query.ops import StreamILFallbackWarning
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer as TServer
from tests.conftest import reach_oracle
from tests.test_torch_packed import _eq, _t, assert_same_index

CPU = "cpu"
FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=7)


def _all_pairs(n):
    u, v = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return u.ravel().astype(np.int32), v.ravel().astype(np.int32)


def _pair(seed, n=60, m=150, extra=80, **kw):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    kw = {**dict(n_cap=n, k=8, k_prime=8, max_iters=64), **FAM, **kw}
    jidx = JIndex.build(JG.make_graph(src, dst, n, m_cap=m + extra), **kw)
    tidx = TIndex.build(TG.make_graph(src, dst, n, m_cap=m + extra,
                                      device=CPU), device=CPU, **kw)
    return jidx, tidx, src, dst


# ------------------------------------------------------------- registry
def test_registry_resolves_and_validates_like_the_reference():
    dl, bl, il = TF.resolve(("dl", "bl", "il"))
    assert (dl.fused_core, bl.fused_core, il.fused_core) == (
        True, True, False)
    assert (il.monoid, il.verdict, il.while_dirty, il.packable) == (
        "min", "negative", "none", False)
    assert il.plane_width(4) == 8 and il.build is TIL.build_il
    assert TF.plugins(("dl", "bl", "il")) == (il,)
    assert (TF.CORE_FAMILIES, TF.DEFAULT_FAMILIES, TF.DEFAULT_IL_DIM) == (
        JF.CORE_FAMILIES, JF.DEFAULT_FAMILIES, JF.DEFAULT_IL_DIM)
    for bad in (("il",), ("bl", "dl", "il"), ("dl", "bl", "nope"),
                ("dl", "bl", "il", "il")):
        with pytest.raises((ValueError, KeyError)) as want:
            JF.resolve(bad)
        with pytest.raises(want.type) as got:
            TF.resolve(bad)
        assert str(got.value) == str(want.value)
    g = TG.make_graph([0], [1], 2, device=CPU)
    with pytest.raises(KeyError, match="unknown label family"):
        TIndex.build(g, n_cap=2, k=2, k_prime=2, device=CPU,
                     families=("dl", "bl", "nope"))


def test_default_families_index_unchanged():
    jidx, tidx, src, dst = _pair(0, families=TF.CORE_FAMILIES)
    base = TIndex.build(tidx.graph, n_cap=60, k=8, k_prime=8, max_iters=64,
                        device=CPU)
    for idx in (tidx, base):
        assert idx.il_in is None and idx.il is None and idx.il_dim is None
        assert idx.families == ("dl", "bl")
        assert_same_index(jidx, idx)
        assert "il_in" not in idx.to_numpy()


# ---------------------------------------------------------- rank draw
_J_RANKS = jax.jit(JIL.rank_plane, static_argnums=(0, 1))


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 - 1])
def test_rank_plane_equals_jax_randint(seed):
    for dim in range(1, 9):
        n_cap = (1, 37, 60_000)[dim % 3]
        want = np.asarray(_J_RANKS(n_cap, dim, seed))
        got = TIL.rank_plane(n_cap, dim, seed, device=CPU)
        assert got.dtype == torch.int32 and got.shape == (n_cap, 2 * dim)
        _eq(got, want, f"dim={dim} n_cap={n_cap}")
        assert TIL.dim_of(got) == dim
    r = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (60_000, 8),
                                      -2 ** 30, 2 ** 30, dtype=jnp.int32))
    _eq(TIL.rank_plane(60_000, 8, seed, device=CPU)[:, :8], r)
    with pytest.raises(ValueError, match="int32"):
        TIL.rank_plane(4, 2, 2 ** 31, device=CPU)


# ------------------------------------------------------- MIN fixpoints
@pytest.mark.parametrize("max_iters", [64, 2])
def test_build_and_insert_il_match(max_iters):
    rng = np.random.default_rng(max_iters)
    n, m = 50, 140
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    gj = JG.make_graph(src, dst, n, m_cap=m + 20)
    gt = TG.make_graph(src, dst, n, m_cap=m + 20, device=CPU)
    gj = JG.delete_edges(gj, jnp.asarray(src[:6]), jnp.asarray(dst[:6]))
    gt = TG.delete_edges(gt, src[:6], dst[:6])
    kw = dict(n_cap=n, dim=3, seed=11, max_iters=max_iters)
    ji, jo, jit = JIL.build_il(gj, **kw)
    ti, to, tit = TIL.build_il(gt, **kw)
    _eq(ti, ji)
    _eq(to, jo)
    assert tit == [int(x) for x in jit]
    if max_iters == 2:
        assert max(tit) == 3          # truncated: the saturation report
    ns = rng.integers(0, n, 12).astype(np.int32)
    nd = rng.integers(0, n, 12).astype(np.int32)
    nd[1] = nd[0]
    gj2 = JG.insert_edges(gj, jnp.asarray(ns), jnp.asarray(nd))
    gt2 = TG.insert_edges(gt, _t(ns), _t(nd))
    want = jax.jit(JIL.insert_update_il,
                   static_argnames=("n_cap", "max_iters"))(
        gj2, ji, jo, jnp.asarray(ns), jnp.asarray(nd), n_cap=n,
        max_iters=max_iters)
    ti_before = ti.clone()
    got = TU.insert_update_plugin("il", gt2, ti, to, _t(ns), _t(nd),
                                  n_cap=n, max_iters=max_iters)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[2] == [int(x) for x in want[2]]
    _eq(ti, ti_before)                      # the input planes are kept
    # the MIN seeding on its own, with a duplicate and an out-of-range id
    at = np.concatenate([nd, [n + 2]]).astype(np.int32)
    vals = np.concatenate([np.asarray(ji)[ns], np.asarray(ji)[:1]])
    sj, fj = jax.jit(JP.seed_scatter_min, static_argnums=3)(
        ji, jnp.asarray(vals), jnp.asarray(at), n)
    st, ft = TP.seed_scatter_min(ti, _t(vals), _t(at), n)
    _eq(st, sj)
    _eq(ft, fj)


# -------------------------------------------------- soundness and gating
def test_il_negative_is_a_sound_prune():
    jidx, tidx, src, dst = _pair(3)
    n = tidx.n_cap
    R = reach_oracle(n, src, dst)
    u, v = _all_pairs(n)
    il_in, il_out = tidx.il
    neg = TIL.il_negative(il_out[u], il_out[v], il_in[u], il_in[v]).numpy()
    _eq(neg, JIL.il_negative(jidx.il_out[u], jidx.il_out[v],
                             jidx.il_in[u], jidx.il_in[v]))
    assert neg.any() and not R[u, v][neg].any()
    base = TIndex.build(tidx.graph, n_cap=n, k=8, k_prime=8, max_iters=64,
                        device=CPU)
    vd_b = base.label_verdicts(u, v).numpy()
    vd_i = tidx.label_verdicts(u, v).numpy()
    _eq(vd_i, jidx.label_verdicts(u, v))
    diff = vd_b != vd_i             # the family only turns -1 into 0
    assert diff.any() and ((vd_b[diff] == -1) & (vd_i[diff] == 0)).all()
    for driver in ("host", "engine"):
        _eq(tidx.query(u, v, driver=driver, bfs_chunk=64), R[u, v])


def test_il_gated_off_exactly_while_dirty():
    """Planes poisoned to call every pair unreachable flip no answer while
    the index is dirty, and the rebuild re-draws them from the seed."""
    jidx, tidx, src, dst = _pair(8)
    n = tidx.n_cap
    u, v = _all_pairs(n)
    ramp = torch.arange(n, dtype=torch.int32)[:, None].expand(
        n, tidx.il_in.shape[1]).contiguous()
    dirty = tidx.delete_edges(src[:1], dst[:1])
    dirty.il_in, dirty.il_out = ramp, ramp
    R = reach_oracle(n, src[1:][(src[1:] != src[0]) | (dst[1:] != dst[0])],
                     dst[1:][(src[1:] != src[0]) | (dst[1:] != dst[0])])
    _eq(dirty.query(u, v, driver="host"), R[u, v])
    for kw in (dict(), dict(bfs_kernel=True, frontier_dtype="packed")):
        eng = TEngine(dirty, bfs_chunk=64, **kw)
        _eq(eng.query(u, v), R[u, v])
        assert eng.stats.prune_hits["il"] == 0
    clean = dirty.rebuild(mode="full")
    jclean = jidx.delete_edges(src[:1], dst[:1]).rebuild(mode="full")
    assert_same_index(jclean, clean)
    eng, jeng = TEngine(clean, bfs_chunk=64), JEngine(jclean, bfs_chunk=64)
    _eq(eng.query(u, v), R[u, v])
    _eq(jeng.query(u, v), R[u, v])
    assert eng.stats.prune_hits == jeng.stats.prune_hits
    assert eng.stats.prune_hits["il"] > 0


# ----------------------------------------------------------- lifecycle
def test_il_lifecycle_matches_jax():
    """build -> insert -> insert -> delete -> delta / full / auto rebuild:
    every field (the interval planes and seed included) and every
    ``rebuild_info`` equal, answers equal to the oracle."""
    jidx, tidx, src, dst = _pair(4, plane_repr="packed")
    n = tidx.n_cap
    rng = np.random.default_rng(4)
    assert tidx.families == ("dl", "bl", "il") and tidx.il_dim == 4
    assert tidx.il_seed == 7
    assert_same_index(jidx, tidx)
    cur_s, cur_d = src, dst
    u, v = _all_pairs(n)
    for _ in range(2):
        ns = rng.integers(0, n, 12).astype(np.int32)
        nd = rng.integers(0, n, 12).astype(np.int32)
        jidx = jidx.insert_edges(ns, nd, max_iters=64, plane_repr="packed")
        tidx = tidx.insert_edges(ns, nd, max_iters=64, plane_repr="packed")
        assert_same_index(jidx, tidx)
        cur_s, cur_d = np.concatenate([cur_s, ns]), np.concatenate([cur_d, nd])
    _eq(tidx.query(u, v, driver="host"), reach_oracle(n, cur_s, cur_d)[u, v])
    jidx = jidx.delete_edges(src[:8], dst[:8])
    tidx = tidx.delete_edges(src[:8], dst[:8])
    assert tidx.is_dirty
    dead = np.isin(cur_s.astype(np.int64) * n + cur_d,
                   src[:8].astype(np.int64) * n + dst[:8])
    R = reach_oracle(n, cur_s[~dead], cur_d[~dead])
    _eq(tidx.query(u, v, driver="host"), R[u, v])
    rebuilt = {}
    for mode in ("delta", "full", "auto"):
        jr, jinfo = jidx.rebuild_info(mode=mode, max_iters=64,
                                      plane_repr="packed")
        tr, tinfo = tidx.rebuild_info(mode=mode, max_iters=64,
                                      plane_repr="packed")
        assert tinfo == jinfo
        assert_same_index(jr, tr)
        rebuilt[mode] = tr
        _eq(tr.query(u, v, driver="host"), R[u, v])
    for f in ("il_in", "il_out"):
        _eq(getattr(rebuilt["delta"], f), getattr(rebuilt["full"], f), f)


def test_from_numpy_round_trips_the_il_fields():
    jidx, tidx, _, _ = _pair(5)
    arrays = tidx.to_numpy()
    assert {"il_in", "il_out", "il_seed"} <= set(arrays)
    back = TIndex.from_numpy(arrays, device=CPU)
    assert back.il_seed == 7 and back.families == tidx.families
    assert_same_index(jidx, back)
    want = {k: np.asarray(v) for k, v in (
        ("il_in", jidx.il_in), ("il_out", jidx.il_out),
        ("il_seed", jidx.il_seed))}
    back = TIndex.from_numpy({**arrays, **want}, device=CPU)
    assert_same_index(jidx, back)


# ------------------------------------------------- engine and server
def test_engine_and_server_prune_hits_match_jax():
    jidx, tidx, src, dst = _pair(8)
    n = tidx.n_cap
    rng = np.random.default_rng(1)
    kw = dict(bfs_chunk=32, max_iters=64)
    je, te = JEngine(jidx, **kw), TEngine(tidx, bfs_kernel=True, **kw)
    for q in (7, 64, 129):
        u = rng.integers(0, n, q).astype(np.int32)
        v = rng.integers(0, n, q).astype(np.int32)
        _eq(te.query(u, v), je.query(u, v))
    hits = te.stats.prune_hits
    assert hits == je.stats.prune_hits and hits["il"] > 0
    assert sum(hits.values()) == te.stats.queries == 7 + 64 + 129
    # a server deletes and rebuilds lazily; the dirty round charges no il
    srvs = [S(None, engine=E(i, **kw), rebuild_dead_ratio=0.05,
              rebuild_mode="auto")
            for S, E, i in ((JServer, JEngine, jidx),
                            (TServer, TEngine, tidx))]
    for r in range(3):
        u = rng.integers(0, n, 100).astype(np.int32)
        v = rng.integers(0, n, 100).astype(np.int32)
        before = [s.engine_stats()["prune_hits"]["il"] for s in srvs]
        dirty = srvs[1].dirty
        outs = [s.query(u, v) for s in srvs]
        _eq(outs[1], outs[0])
        if dirty and not srvs[1].engine_stats()["rebuilds"]:
            assert srvs[1].engine_stats()["prune_hits"]["il"] == before[1]
        for s in srvs:
            s.insert(src[r:r + 3], dst[:3])
            s.delete(src[5 * r:5 * r + 5], dst[5 * r:5 * r + 5])
    js, ts = (s.engine_stats() for s in srvs)
    for key in ("prune_hits", "rebuilds", "delta_rebuilds", "last_rebuild",
                "queries", "deletes", "inserts"):
        assert ts[key] == js[key], key
    assert ts["rebuilds"] >= 1


def test_streaming_il_fallback_warns_once_per_engine():
    jidx, tidx, _, _ = _pair(9)
    n = tidx.n_cap
    u, v = _all_pairs(n)
    want = JEngine(jidx, bfs_chunk=64).query(u, v)
    for _ in range(2):     # a second engine warns again
        eng = TEngine(tidx, bfs_chunk=64, bfs_kernel=True, streaming=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _eq(eng.query(u, v), want)
            _eq(eng.query(v, u), JEngine(jidx, bfs_chunk=64).query(v, u))
        assert sum(issubclass(w.category, StreamILFallbackWarning)
                   for w in caught) == 1
