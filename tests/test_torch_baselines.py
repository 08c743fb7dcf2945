"""The paper's baselines in the port (B-BFS, IP-lite, the DAG-maintenance
proxy), held bitwise against the JAX package and the dense reachability
oracle on seeded random graphs.

Every random graph is padded to one vertex capacity (``N_CAP``) and one
edge capacity (``M_CAP``), so the JAX side compiles each function once;
vertices past ``n`` are isolated and change no answer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import bbfs as jbbfs
from repro.baselines import dag_maintain as jdag
from repro.baselines import ip_lite as jip
from repro.core import DBLIndex as JIndex
from repro.core import make_graph as j_make_graph
from repro_torch.baselines import bbfs as tbbfs
from repro_torch.baselines import dag_maintain as tdag
from repro_torch.baselines import ip_lite as tip
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import make_graph as t_make_graph
from tests._hyp import given, settings, st
from tests.conftest import reach_oracle, random_graph

CPU = "cpu"
N_CAP = 24
M_CAP = 80
#: enough rounds for any path in a graph of N_CAP vertices
ITERS = 2 * N_CAP + 2


def _graphs(seed, extra=0):
    """(rng, n, src, dst, JAX graph, port graph) of one seeded graph,
    ``extra`` edge slots of headroom beyond ``M_CAP`` for inserts."""
    rng = np.random.default_rng(seed)
    n, src, dst = random_graph(rng, n_max=N_CAP, m_max=M_CAP)
    return (rng, n, src, dst,
            j_make_graph(src, dst, n, m_cap=M_CAP + extra),
            t_make_graph(src, dst, n, m_cap=M_CAP + extra, device=CPU))


def _all_pairs(n):
    u, v = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return u.ravel().astype(np.int32), v.ravel().astype(np.int32)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_bbfs_equals_reference_and_oracle(seed):
    rng, n, src, dst, jg, tg = _graphs(seed)
    u = rng.integers(0, n, 50).astype(np.int32)
    v = rng.integers(0, n, 50).astype(np.int32)
    got = tbbfs.query(tg, u, v, n_cap=N_CAP, chunk=16, max_iters=ITERS)
    want = jbbfs.query(jg, u, v, n_cap=N_CAP, chunk=16, max_iters=ITERS)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reach_oracle(n, src, dst)[u, v])


@pytest.mark.parametrize("max_iters", [1, 2])
@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_bbfs_truncated_equals_reference(max_iters, seed):
    """Lanes cut off at ``max_iters`` answer as the reference's do."""
    rng, n, src, dst, jg, tg = _graphs(seed)
    u = rng.integers(0, n, 40).astype(np.int32)
    v = rng.integers(0, n, 40).astype(np.int32)
    got = tbbfs.query(tg, u, v, n_cap=N_CAP, chunk=16, max_iters=max_iters)
    want = jbbfs.query(jg, u, v, n_cap=N_CAP, chunk=16, max_iters=max_iters)
    np.testing.assert_array_equal(got, want)


def _reference_directions(src, dst, u, v, max_iters):
    """The directions the reference's loop takes (``bbfs.py``'s body in
    numpy): forward when the forward frontier holds no more bits than the
    backward one over every lane, answered lanes included."""
    ids = np.arange(N_CAP)
    f_seen, b_seen = ids[:, None] == u[None, :], ids[:, None] == v[None, :]
    f_fr, b_fr, hit = f_seen, b_seen, u == v
    out = []
    while len(out) < max_iters and (f_fr.any(0) & b_fr.any(0) & ~hit).any():
        forward = f_fr.sum() <= b_fr.sum()
        tails, heads, fr, seen = ((src, dst, f_fr, f_seen) if forward
                                  else (dst, src, b_fr, b_seen))
        nxt = np.zeros_like(fr)
        np.logical_or.at(nxt, heads, fr[tails])
        nxt &= ~seen & ~hit[None, :]
        if forward:
            f_fr, f_seen = nxt, f_seen | nxt
        else:
            b_fr, b_seen = nxt, b_seen | nxt
        hit = hit | (f_seen & b_seen).any(0)
        out.append("fwd" if forward else "bwd")
    return out


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_bbfs_direction_rule(seed):
    """A truncated lane's answer does not depend on the directions taken
    (after t rounds it is hit iff dist(u, v) <= t, or its search ended), so
    the rule is pinned by the sequence itself: the port's, recorded at its
    relax step, equals the reference's loop spelled in numpy, with 6 of 16
    lanes padding (vertex 0 to itself: hit from the start, yet counted)."""
    rng, n, src, dst, jg, tg = _graphs(seed)
    u = np.zeros(16, np.int32)
    v = np.zeros(16, np.int32)
    u[:10] = rng.integers(0, n, 10)
    v[:10] = rng.integers(0, n, 10)
    tags, seq = {}, []
    relax_edges, relax = tbbfs.relax_edges, tbbfs.relax

    def tagged_edges(tails, heads, live, n_cap):
        out = relax_edges(tails, heads, live, n_cap)
        tags[id(out[0])] = "bwd" if tags else "fwd"
        return out

    def recorded_relax(frontier, tails, *args, **kw):
        seq.append(tags[id(tails)])
        return relax(frontier, tails, *args, **kw)

    tbbfs.relax_edges, tbbfs.relax = tagged_edges, recorded_relax
    try:
        hit = tbbfs.bbfs_chunk(tg, torch.from_numpy(u), torch.from_numpy(v),
                               n_cap=N_CAP, max_iters=ITERS)
    finally:
        tbbfs.relax_edges, tbbfs.relax = relax_edges, relax
    assert seq == _reference_directions(src, dst, u, v, ITERS)
    np.testing.assert_array_equal(
        hit.numpy(), np.asarray(jbbfs.bbfs_chunk(
            jg, jnp.asarray(u), jnp.asarray(v), n_cap=N_CAP,
            max_iters=ITERS)))


@pytest.mark.parametrize("n_cap,k", [(N_CAP, 4), (70_000, 8)])
def test_ip_hashes_equal_reference(n_cap, k):
    """At 70 000 ids the products wrap past 2**32."""
    got = tip._hashes(n_cap, k)
    assert got.dtype == np.int32 and got.min() >= 0
    np.testing.assert_array_equal(got, np.asarray(jip._hashes(n_cap, k)))


def _same_ip(jidx, tidx):
    np.testing.assert_array_equal(tidx.label_in.numpy(),
                                  np.asarray(jidx.label_in))
    np.testing.assert_array_equal(tidx.label_out.numpy(),
                                  np.asarray(jidx.label_out))


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_ip_lite_equals_reference_and_oracle(seed):
    rng, n, src, dst, jg, tg = _graphs(seed, extra=4)
    jidx = jip.IPIndex.build(jg, n_cap=N_CAP, k=4, max_iters=ITERS)
    tidx = tip.IPIndex.build(tg, n_cap=N_CAP, k=4, max_iters=ITERS)
    _same_ip(jidx, tidx)
    u, v = _all_pairs(n)
    np.testing.assert_array_equal(
        tip.ip_verdicts(tidx, torch.from_numpy(u),
                        torch.from_numpy(v)).numpy(),
        np.asarray(jip.ip_verdicts(jidx, jnp.asarray(u), jnp.asarray(v))))
    got = tidx.query(u, v, chunk=16, max_iters=ITERS)
    np.testing.assert_array_equal(got, jidx.query(u, v, chunk=16,
                                                  max_iters=ITERS))
    np.testing.assert_array_equal(got.reshape(n, n),
                                  reach_oracle(n, src, dst))
    # an insert whose endpoints repeat: two edges share a tail, two a
    # head, and one edge comes twice
    ns = rng.integers(0, n, 4).astype(np.int32)
    nd = rng.integers(0, n, 4).astype(np.int32)
    ns[1], nd[2] = ns[0], nd[0]
    ns[3], nd[3] = ns[0], nd[0]
    jidx2 = jidx.insert_edges(ns, nd, max_iters=ITERS)
    tidx2 = tidx.insert_edges(ns, nd, max_iters=ITERS)
    _same_ip(jidx2, tidx2)
    got2 = tidx2.query(u, v, chunk=16, max_iters=ITERS)
    np.testing.assert_array_equal(got2, jidx2.query(u, v, chunk=16,
                                                    max_iters=ITERS))
    np.testing.assert_array_equal(
        got2.reshape(n, n), reach_oracle(n, np.concatenate([src, ns]),
                                         np.concatenate([dst, nd])))


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_scc_condense_equals_reference(seed):
    _, n, src, dst, _, _ = _graphs(seed)
    for got, want in zip(tdag.scc_condense_numpy(n, src, dst),
                         jdag.scc_condense_numpy(n, src, dst)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tdag.dag_stats(n, src, dst) == jdag.dag_stats(n, src, dst)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_scc_fwbw_round_equals_reference(seed):
    rng, n, src, dst, jg, tg = _graphs(seed)
    comp, _, _ = tdag.scc_condense_numpy(n, src, dst)
    every = np.arange(N_CAP) < n
    for unclassified in (every, every & (rng.random(N_CAP) < 0.6)):
        got = tdag.scc_fwbw_round(tg, torch.from_numpy(unclassified),
                                  n_cap=N_CAP, max_iters=ITERS)
        want = jdag.scc_fwbw_round(jg, jnp.asarray(unclassified),
                                   n_cap=N_CAP, max_iters=ITERS)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # with every vertex unclassified the pivot is vertex 0
    scc = tdag.scc_fwbw_round(tg, torch.from_numpy(every), n_cap=N_CAP,
                              max_iters=ITERS)[0].numpy()
    np.testing.assert_array_equal(scc[:n], comp == comp[0])


def test_fwbw_round_and_dag_stats_on_a_cycle():
    # cycle 0->1->2->0 plus tail 2->3
    src = np.asarray([0, 1, 2, 2], np.int32)
    dst = np.asarray([1, 2, 0, 3], np.int32)
    g = t_make_graph(src, dst, 4, device=CPU)
    scc, fwd, bwd = tdag.scc_fwbw_round(g, torch.ones(4, dtype=torch.bool),
                                        n_cap=4, max_iters=8)
    np.testing.assert_array_equal(scc.numpy(), [True, True, True, False])
    np.testing.assert_array_equal(fwd.numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(bwd.numpy(), [0, 0, 0, 3])
    assert tdag.dag_stats(4, src, dst) == {"dag_v": 2, "dag_e": 1}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_stream_through_both_packages(seed):
    """DBL and IP-lite built, queried, checked by B-BFS, extended by an
    insert and queried again, in both packages: every answer equal."""
    rng = np.random.default_rng(seed)
    n, m, inserts = 60, 200, 12
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    jg = j_make_graph(src, dst, n, m_cap=m + inserts)
    tg = t_make_graph(src, dst, n, m_cap=m + inserts, device=CPU)
    kw = dict(n_cap=n, k=8, k_prime=8, max_iters=64)
    jd = JIndex.build(jg, **kw)
    td = TIndex.build(tg, device=CPU, **kw)
    ji = jip.IPIndex.build(jg, n_cap=n, k=8, max_iters=64)
    ti = tip.IPIndex.build(tg, n_cap=n, k=8, max_iters=64)
    u = rng.integers(0, n, 300).astype(np.int32)
    v = rng.integers(0, n, 300).astype(np.int32)
    ns = rng.integers(0, n, inserts).astype(np.int32)
    nd = rng.integers(0, n, inserts).astype(np.int32)
    for step in range(2):
        want = reach_oracle(n, *(np.concatenate([a, b[:inserts * step]])
                                 for a, b in ((src, ns), (dst, nd))))[u, v]
        answers = {
            "jax_dbl": jd.query(u, v, bfs_chunk=32, max_iters=64),
            "port_dbl": td.query(u, v, bfs_chunk=32, max_iters=64),
            "jax_ip": ji.query(u, v, chunk=32, max_iters=64),
            "port_ip": ti.query(u, v, chunk=32, max_iters=64),
            "jax_bbfs": jbbfs.query(jd.graph, u, v, n_cap=n, chunk=32,
                                    max_iters=64),
            "port_bbfs": tbbfs.query(td.graph, u, v, n_cap=n, chunk=32,
                                     max_iters=64)}
        for name, ans in answers.items():
            np.testing.assert_array_equal(np.asarray(ans), want,
                                          err_msg=f"step {step}: {name}")
        jd = jd.insert_edges(ns, nd, max_iters=64)
        td = td.insert_edges(ns, nd, max_iters=64)
        ji = ji.insert_edges(ns, nd, max_iters=64)
        ti = ti.insert_edges(ns, nd, max_iters=64)
    _same_ip(ji, ti)


def test_baselines_follow_the_graphs_device():
    """Nothing moves off the graph's device: the labels and every answer
    are made where the graph lives."""
    src = np.asarray([0, 1, 2], np.int32)
    dst = np.asarray([1, 2, 0], np.int32)
    g = t_make_graph(src, dst, 3, device=CPU)
    idx = tip.IPIndex.build(g, n_cap=3, k=2, max_iters=8)
    assert idx.label_in.device == g.device == idx.label_out.device
    hit = tbbfs.bbfs_chunk(g, torch.tensor([0, 2]), torch.tensor([2, 1]),
                           n_cap=3, max_iters=8)
    assert hit.device == g.device and hit.tolist() == [True, True]
