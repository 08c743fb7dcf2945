"""Port parity for the core modules: generators, graph, select, propagate,
label build and insert maintenance, held bitwise against the JAX package."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as JB
from repro.core import graph as JG
from repro.core import labels as JL
from repro.core import select as JS
from repro.core import update as JU
from repro.graphs import generators as JGen
from repro_torch.core import bitset as TB
from repro_torch.core import graph as TG
from repro_torch.core import labels as TL
from repro_torch.core import select as TS
from repro_torch.core import update as TU
from repro_torch.graphs import generators as TGen

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _graphs(n, src, dst, m_cap=None):
    return (JG.make_graph(src, dst, n, m_cap=m_cap),
            TG.make_graph(src, dst, n, m_cap=m_cap, device=CPU))


@pytest.mark.parametrize("name", sorted(JGen.TABLE2_PRESETS))
def test_table2_generators_match(name):
    n0, s0, d0 = JGen.table2_graph(name, seed=3, scale=0.01)
    n1, s1, d1 = TGen.table2_graph(name, seed=3, scale=0.01)
    assert n0 == n1
    _eq(s0, s1)
    _eq(d0, d1)
    assert TGen.TABLE2_PRESETS[name][:2] == JGen.TABLE2_PRESETS[name][:2]


def test_make_graph_takes_n_cap_and_ignores_it():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 3], np.int32)
    gj = JG.make_graph(src, dst, 4, n_cap=8, m_cap=5)
    gt = TG.make_graph(src, dst, 4, n_cap=8, m_cap=5, device=CPU)
    plain = TG.make_graph(src, dst, 4, m_cap=5, device=CPU)
    assert gt.n_cap == gj.n_cap == -1
    for f in ("src", "dst", "n", "del_at"):
        _eq(getattr(gj, f), getattr(gt, f))
        _eq(getattr(plain, f), getattr(gt, f))
    assert gt.m == int(gj.m) and gt.m_cap == gj.m_cap == 5


def test_graph_make_insert_degrees_match():
    rng = np.random.default_rng(0)
    n, m = 40, 120
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    gj, gt = _graphs(n, src, dst, m_cap=m + 20)
    for a, b in zip(JG.degrees(gj, 48), TG.degrees(gt, 48)):
        _eq(a, b)
    ns = rng.integers(0, 45, 12).astype(np.int32)   # grows n past 40
    nd = rng.integers(0, 45, 12).astype(np.int32)
    gj = JG.insert_edges(gj, jnp.asarray(ns), jnp.asarray(nd))
    gt = TG.insert_edges(gt, torch.from_numpy(ns), torch.from_numpy(nd))
    for f in ("src", "dst", "del_at", "n"):
        _eq(getattr(gj, f), getattr(gt, f))
    assert int(gj.m) == gt.m and int(gj.del_epoch) == gt.del_epoch
    _eq(JG.edge_mask(gj), TG.edge_mask(gt))
    for a, b in zip(JG.degrees(gj, 48), TG.degrees(gt, 48)):
        _eq(a, b)
    _eq(JG.reverse(gj).src, TG.reverse(gt).src)
    # a batch past m_cap drops its overflow slots in both
    big = np.arange(30, dtype=np.int32) % 40
    gj2 = JG.insert_edges(gj, jnp.asarray(big), jnp.asarray(big[::-1]))
    gt2 = TG.insert_edges(gt, torch.from_numpy(big),
                          torch.from_numpy(big[::-1].copy()))
    _eq(gj2.src, gt2.src)
    _eq(JG.edge_mask(gj2), TG.edge_mask(gt2))


@pytest.mark.parametrize("k", [1, 31, 32, 40, 64, 96])
def test_bitset_pack_unpack_pad_mask_match(k):
    bits = np.random.default_rng(k).random((9, k)) < 0.5
    jw = np.asarray(JB.pack(jnp.asarray(bits)))
    tw = TB.pack(torch.from_numpy(bits))
    _eq(jw.view(np.int32), tw)
    _eq(TB.unpack(tw, k), bits)
    _eq(np.asarray(JB.pad_mask(k)).view(np.int32), TB.pad_mask(k))
    assert TB.n_words(k) == JB.n_words(k) == tw.shape[1]
    other = TB.pack(torch.from_numpy(~bits))
    _eq(TB.intersect_any(tw, other),
        JB.intersect_any(jnp.asarray(jw), JB.pack(jnp.asarray(~bits))))
    _eq(TB.subset(tw, tw | other),
        JB.subset(jnp.asarray(jw), jnp.asarray(jw) | JB.pack(
            jnp.asarray(~bits))))


def test_leaf_hash_matches_over_int31_range():
    ids = np.concatenate([np.arange(0, 5000),
                          np.random.default_rng(1).integers(0, 2**31 - 1,
                                                            5000),
                          [2**31 - 1, 2**31 - 2, 2**30]]).astype(np.int32)
    for kp in (7, 32, 64, 100):
        _eq(JS.leaf_hash(jnp.asarray(ids), kp),
            TS.leaf_hash(torch.from_numpy(ids), kp))


@pytest.mark.parametrize("method", ["product", "max", "min", "sum",
                                    "betweenness"])
def test_select_landmarks_ties_and_leaves_match(method):
    # a star-and-ring graph: many vertices share each degree pair, so the
    # top-k cut falls inside a tie and the order among equals decides lanes
    n = 96
    src, dst = [], []
    for i in range(n):
        src += [i, i]
        dst += [(i + 1) % n, (i + 7) % n]
    for hub in (3, 50, 77):
        src += [hub] * 5
        dst += [(hub + j * 11) % n for j in range(1, 6)]
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    gj, gt = _graphs(n, src, dst)
    _eq(JS.centrality(gj, 100, method), TS.centrality(gt, 100, method))
    for k in (5, 16, 40):
        _eq(JS.select_landmarks(gj, n_cap=100, k=k, method=method),
            TS.select_landmarks(gt, n_cap=100, k=k, method=method))
    for r in (0, 6):
        for a, b in zip(JS.leaf_masks(gj, n_cap=100, leaf_r=r),
                        TS.leaf_masks(gt, n_cap=100, leaf_r=r)):
            _eq(a, b)


def test_select_landmarks_k_above_n_cap_raises_as_reference():
    """k > n_cap raises ``ValueError`` on both sides (``lax.top_k`` in the
    reference), through ``select_landmarks`` and ``DBLIndex.build``;
    k' > n_cap stays valid, and both sides build the same index."""
    from repro.core import DBLIndex as JIndex
    from repro_torch.core import DBLIndex as TIndex
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 3], np.int32)
    gj, gt = _graphs(4, src, dst)
    for sel in (lambda: JS.select_landmarks(gj, n_cap=6, k=8),
                lambda: TS.select_landmarks(gt, n_cap=6, k=8),
                lambda: JIndex.build(gj, n_cap=6, k=8, k_prime=8),
                lambda: TIndex.build(gt, n_cap=6, k=8, k_prime=8,
                                     device=CPU)):
        with pytest.raises(ValueError, match="top_k"):
            sel()
    ij = JIndex.build(gj, n_cap=6, k=2, k_prime=8)
    it = TIndex.build(gt, n_cap=6, k=2, k_prime=8, device=CPU)
    for name in ("landmarks", "dl_in", "dl_out", "bl_in", "bl_out"):
        _eq(getattr(ij, name), getattr(it, name))
    u = np.array([0, 0, 3, 1, 2, 5], np.int32)
    v = np.array([3, 2, 0, 1, 4, 5], np.int32)
    _eq(ij.query(u, v, driver="host"), it.query(u, v, driver="host"))


@pytest.mark.parametrize("gen,max_iters", [
    ("power_law", 64), ("dag_like", 64), ("dag_like", 3)])
def test_build_planes_and_iters_match(gen, max_iters):
    n, m, k, kp = 300, 900, 16, 24
    src, dst = getattr(JGen, gen)(n, m, seed=2)
    gj, gt = _graphs(n + 20, src, dst)
    n_cap = n + 20
    lj = JS.select_landmarks(gj, n_cap=n_cap, k=k)
    lt = TS.select_landmarks(gt, n_cap=n_cap, k=k)
    _eq(lj, lt)
    dj = JL.build_dl(gj, lj, n_cap=n_cap, k=k, max_iters=max_iters)
    dt = TL.build_dl(gt, lt, n_cap=n_cap, k=k, max_iters=max_iters)
    sj = JS.leaf_masks(gj, n_cap=n_cap)
    st = TS.leaf_masks(gt, n_cap=n_cap)
    bj = JL.build_bl(gj, *sj, n_cap=n_cap, k_prime=kp, max_iters=max_iters)
    bt = TL.build_bl(gt, *st, n_cap=n_cap, k_prime=kp, max_iters=max_iters)
    for a, b in ((dj, dt), (bj, bt)):
        _eq(a[0], b[0])
        _eq(a[1], b[1])
        assert [int(x) for x in np.asarray(a[2])] == b[2]
    iters = dt[2] + bt[2]
    if max_iters == 3:   # the dag's long chains cannot converge in 3
        assert max(iters) == max_iters + 1
        assert TU.saturated(iters, max_iters)
    else:
        assert not TU.saturated(iters, max_iters)


def test_insert_and_update_three_batches_match():
    n, m, k, kp = 200, 500, 16, 16
    src, dst = JGen.dag_like(n, m, seed=4, back_frac=0.0)
    gj, gt = _graphs(n, src, dst, m_cap=m + 60)
    lj = JS.select_landmarks(gj, n_cap=n, k=k)
    lt = TS.select_landmarks(gt, n_cap=n, k=k)
    dj_in, dj_out, _ = JL.build_dl(gj, lj, n_cap=n, k=k)
    bj_in, bj_out, _ = JL.build_bl(gj, *JS.leaf_masks(gj, n_cap=n),
                                   n_cap=n, k_prime=kp)
    dt_in, dt_out, _ = TL.build_dl(gt, lt, n_cap=n, k=k)
    bt_in, bt_out, _ = TL.build_bl(gt, *TS.leaf_masks(gt, n_cap=n),
                                   n_cap=n, k_prime=kp)
    jstate = (gj, dj_in, dj_out, bj_in, bj_out)
    tstate = (gt, dt_in, dt_out, bt_in, bt_out)
    rng = np.random.default_rng(9)
    batches = [
        (rng.integers(0, n, 15), rng.integers(0, n, 15)),
        # back edges high -> low on a forward DAG: merges SCCs
        (np.array([190, 150, 120, 100]), np.array([5, 20, 40, 60])),
        (rng.integers(0, n, 20), rng.integers(0, n, 20)),
    ]
    ej, et = 0, 0
    for ns, nd in batches:
        ns = ns.astype(np.int32)
        nd = nd.astype(np.int32)
        outj = JU.insert_and_update(*jstate, jnp.asarray(ns),
                                    jnp.asarray(nd), ej, n_cap=n,
                                    max_iters=64)
        outt = TU.insert_and_update(*tstate, torch.from_numpy(ns),
                                    torch.from_numpy(nd), et, n_cap=n,
                                    max_iters=64)
        for a, b in zip(outj[1:5], outt[1:5]):
            _eq(a, b)
        assert [int(x) for x in np.asarray(outj[5])] == outt[5]
        assert int(outj[6]) == outt[6]
        _eq(outj[0].src, outt[0].src)
        jstate, ej = outj[:5], outj[6]
        tstate, et = outt[:5], outt[6]


def test_insert_saturation_reports_max_iters_plus_one():
    n = 60
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)        # one long chain
    gt = TG.make_graph(src, dst, n, m_cap=n + 4, device=CPU)
    lt = TS.select_landmarks(gt, n_cap=n, k=4)
    dl_in, dl_out, it = TL.build_dl(gt, lt, n_cap=n, k=4, max_iters=n + 2)
    assert max(it) <= n + 2
    bl_in, bl_out, _ = TL.build_bl(gt, *TS.leaf_masks(gt, n_cap=n),
                                   n_cap=n, k_prime=8, max_iters=n + 2)
    # closing the chain into a cycle re-labels every vertex, one hop a round
    out = TU.insert_and_update(
        gt, dl_in, dl_out, bl_in, bl_out,
        torch.tensor([n - 1], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32), 0, n_cap=n, max_iters=5)
    assert max(out[5]) == 6 and TU.saturated(out[5], 5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gj = JG.make_graph(src, dst, n, m_cap=n + 4)
        lj = JS.select_landmarks(gj, n_cap=n, k=4)
        dj = JL.build_dl(gj, lj, n_cap=n, k=4, max_iters=n + 2)
        bj = JL.build_bl(gj, *JS.leaf_masks(gj, n_cap=n), n_cap=n,
                         k_prime=8, max_iters=n + 2)
        outj = JU.insert_and_update(gj, dj[0], dj[1], bj[0], bj[1],
                                    jnp.asarray([n - 1], jnp.int32),
                                    jnp.asarray([0], jnp.int32), 0,
                                    n_cap=n, max_iters=5)
    assert [int(x) for x in np.asarray(outj[5])] == out[5]
    for a, b in zip(outj[1:5], out[1:5]):
        _eq(a, b)


@pytest.mark.parametrize("name", ["Monoid", "PlaneRepr", "HaloMode"])
def test_propagate_literal_aliases_match(name):
    import typing
    from repro.core import propagate as JP
    from repro_torch.core import propagate as TP
    assert typing.get_args(getattr(TP, name)) == \
        typing.get_args(getattr(JP, name))
    assert typing.get_origin(getattr(TP, name)) is typing.Literal


def test_plane_store_k_prime_matches():
    from repro.core import planes as JPL
    from repro_torch.core import planes as TPL
    lm = np.array([0, 3, 5], np.int32)
    src_m = np.zeros(16, bool)
    src_m[[1, 2]] = True
    j = JPL.PlaneStore.seeds(jnp.asarray(lm), jnp.asarray(src_m),
                             jnp.asarray(src_m), n_cap=16, k=3, k_prime=5)
    t = TPL.PlaneStore.seeds(torch.from_numpy(lm), torch.from_numpy(src_m),
                             torch.from_numpy(src_m), n_cap=16, k=3,
                             k_prime=5)
    assert t.k_prime == j.k_prime == 5 and t.k == j.k == 3


def test_layout_of_replicated_and_vertex_sharded():
    """What the port records: a replicated index and a bare plane are
    ``REPLICATED`` (the reference's answer for an unsharded plane); a
    vertex shard is its layout, with the reference's kind, axis and shard
    count; a one-shard layout is ``REPLICATED``, as the reference's is."""
    from repro.core import planes as JPL
    from repro_torch.core import DBLIndex
    from repro_torch.core import distributed as TD
    from repro_torch.core import planes as TPL
    src, dst = JGen.power_law(64, 300, seed=4)
    idx = DBLIndex.build(TG.make_graph(src, dst, 64, device=CPU), n_cap=64,
                         k=8, k_prime=8, device=CPU)
    assert TPL.layout_of(idx) == TPL.layout_of(idx.dl_in) == TPL.REPLICATED
    assert JPL.layout_of(jnp.zeros((64, 8), bool)) == JPL.REPLICATED
    for shards in (1, 4):
        mesh = TD.VertexMesh(None, shards - 1, shards, torch.device(CPU))
        lay = TPL.layout_of(TD.place_vertex_sharded(idx, mesh))
        if shards == 1:
            assert lay == TPL.REPLICATED
        else:
            assert (lay.kind, lay.axis, lay.shards, lay.rank) == \
                ("vertex_sharded", "vertex", 4, 3)
