"""The port's interval planes ("il") against the plain reference
(``reachbench.il_reference``): the dense closure and the Jacobi fixpoint
agree with each other and with the definition, and the served index's
``il_in``/``il_out`` equal both exactly (int32, no tolerance) after the
build, after each insert batch through the server, and after a delete and
a rebuild; the served answers equal the plain BFS reference's
(``reachbench.reference``) on the live edges."""
import numpy as np
import pytest
import torch

from repro_torch.core.dbl import DBLIndex
from repro_torch.core.graph import edge_mask, make_graph
from repro_torch.core.interval import rank_plane
from repro_torch.graphs.generators import power_law
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.reach_server import ReachabilityServer

from reachbench import il_reference as ILR
from reachbench import reference as REF

N, M = 220, 600


def _live(g):
    mask = edge_mask(g)
    return g.src[mask], g.dst[mask]


def _assert_planes(idx):
    """The index's planes equal both references over its live edges."""
    src, dst = _live(idx.graph)
    seed = rank_plane(idx.n_cap, idx.il_dim, idx.il_seed, "cpu")
    for il_in, il_out in (ILR.by_closure(src, dst, seed),
                          ILR.by_fixpoint(src, dst, seed)):
        assert il_in.dtype == idx.il_in.dtype == torch.int32
        assert torch.equal(il_in, idx.il_in)
        assert torch.equal(il_out, idx.il_out)


def test_reference_by_definition_on_a_path_and_a_cycle():
    # 0 -> 1 -> 2, 3 <-> 4, 5 alone
    src = torch.tensor([0, 1, 3, 4])
    dst = torch.tensor([1, 2, 4, 3])
    r = torch.tensor([[5], [3], [9], [7], [1], [4]], dtype=torch.int32)
    seed = torch.cat([r, -r], 1)
    want_in = torch.tensor([[5, -5], [3, -5], [3, -9], [1, -7], [1, -7],
                            [4, -4]], dtype=torch.int32)
    want_out = torch.tensor([[3, -9], [3, -9], [9, -9], [1, -7], [1, -7],
                             [4, -4]], dtype=torch.int32)
    for il_in, il_out in (ILR.by_closure(src, dst, seed),
                          ILR.by_fixpoint(src, dst, seed)):
        assert torch.equal(il_in, want_in)
        assert torch.equal(il_out, want_out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_closure_and_fixpoint_agree(seed):
    rng = np.random.default_rng(seed)
    n = 150
    src = torch.from_numpy(rng.integers(0, n, 400))
    dst = torch.from_numpy(rng.integers(0, n, 400))
    plane = rank_plane(n, 3, seed, "cpu")
    a, b = ILR.by_closure(src, dst, plane), ILR.by_fixpoint(src, dst, plane)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # a vertex's row holds its own ranks or lower
    assert bool((a[0] <= plane).all()) and bool((a[1] <= plane).all())


def test_closure_refuses_a_large_graph():
    e = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        ILR.closure(e, e, ILR.CLOSURE_MAX_N + 1)


@pytest.mark.parametrize("il_dim,il_seed,graph_seed",
                         [(4, 0, 3), (2, 7, 5), (4, 11, 9)])
def test_served_planes_equal_the_reference(il_dim, il_seed, graph_seed):
    src, dst = power_law(N, M, seed=graph_seed)
    g = make_graph(src, dst, N, m_cap=M + 400, device="cpu")
    idx = DBLIndex.build(g, n_cap=N, k=16, k_prime=16, device="cpu",
                         families=("dl", "bl", "il"), il_dim=il_dim,
                         il_seed=il_seed)
    assert idx.il_dim == il_dim and idx.il_seed == il_seed
    _assert_planes(idx)
    eng = QueryEngine(idx, bfs_chunk=16, bfs_kernel=True, device="cpu")
    srv = ReachabilityServer(None, engine=eng, rebuild_dead_ratio=1.0)
    rng = np.random.default_rng(graph_seed)
    for _ in range(4):
        srv.insert(rng.integers(0, N, 50), rng.integers(0, N, 50))
        _assert_planes(srv.index)
        u, v = rng.integers(0, N, 300), rng.integers(0, N, 300)
        got = np.asarray(srv.query(u, v), dtype=bool)
        ls, ld = _live(srv.index.graph)
        want = REF.reach(ls, ld, N, torch.from_numpy(u), torch.from_numpy(v))
        np.testing.assert_array_equal(got, want.numpy())
    # a delete leaves the planes stale (the family answers nothing while
    # dirty); the rebuild re-derives them over the live edges
    ls, ld = _live(srv.index.graph)
    pick = rng.choice(ls.numel(), 60, replace=False)
    srv.delete(ls[pick].numpy(), ld[pick].numpy())
    u, v = rng.integers(0, N, 300), rng.integers(0, N, 300)
    got = np.asarray(srv.query(u, v), dtype=bool)
    ls, ld = _live(srv.index.graph)
    want = REF.reach(ls, ld, N, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(got, want.numpy())
    srv.rebuild()
    _assert_planes(srv.index)
    got = np.asarray(srv.query(u, v), dtype=bool)
    np.testing.assert_array_equal(got, want.numpy())
