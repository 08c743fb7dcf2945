"""The port's graph substrate (segment ops, generators, batching,
``to_networkx``, the samplers) and the two example twins, held against
the JAX package on seeded inputs.

Integer and boolean outputs are compared bitwise.  The float segment
reductions that add (sum, mean, std, softmax) add in another order than
XLA does, so they are compared with rtol 1e-5, atol 1e-6; max, min,
gathers and degree counts bitwise."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DBLIndex as JIndex
from repro.core import graph as JG
from repro.graphs import batching as JB
from repro.graphs import generators as JGen
from repro.graphs import sampler as JS
from repro.graphs import segment as JSeg
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import graph as TG
from repro_torch.graphs import batching as TB
from repro_torch.graphs import generators as TGen
from repro_torch.graphs import sampler as TS
from repro_torch.graphs import segment as TSeg

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
#: reductions that add, and so are compared with TOL
ADDING = ("scatter_sum", "scatter_mean", "scatter_std")


def _edges(seed, n=30, m=200, out_of_range=False):
    """(rng, n, edge_index (2, m)): destinations skip vertex n - 1 (an
    empty segment); with ``out_of_range`` the last edge points at n, which
    the reductions drop."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, m),
                   rng.integers(0, n - 1, m)]).astype(np.int32)
    if out_of_range:
        ei[1, -1] = n
    return rng, n, ei


@pytest.mark.parametrize("name", ["scatter_sum", "scatter_mean",
                                  "scatter_max", "scatter_min",
                                  "scatter_std"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_ops_equal_reference(name, seed):
    rng, n, ei = _edges(seed, out_of_range=True)
    msg = rng.normal(size=(ei.shape[1], 8)).astype(np.float32)
    got = getattr(TSeg, name)(torch.from_numpy(msg), torch.from_numpy(ei),
                              n).numpy()
    want = np.asarray(getattr(JSeg, name)(jnp.asarray(msg), jnp.asarray(ei),
                                          n))
    assert got.shape == want.shape and got.dtype == want.dtype
    if name in ADDING:
        np.testing.assert_allclose(got, want, **TOL)
    else:   # the empty segment holds -inf (max) or +inf (min)
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got[n - 1]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_degrees_softmax_equal_reference(seed):
    rng, n, ei = _edges(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    tei, jei = torch.from_numpy(ei), jnp.asarray(ei)
    np.testing.assert_array_equal(
        TSeg.gather_src(torch.from_numpy(x), tei).numpy(),
        np.asarray(JSeg.gather_src(jnp.asarray(x), jei)))
    deg = TSeg.degrees_from_edges(tei, n).numpy()
    assert deg.dtype == np.float32 and deg[n - 1] == 0
    np.testing.assert_array_equal(deg,
                                  np.asarray(JSeg.degrees_from_edges(jei, n)))
    scores = rng.normal(size=ei.shape[1]).astype(np.float32) * 4
    np.testing.assert_allclose(
        TSeg.segment_softmax(torch.from_numpy(scores), tei[1], n).numpy(),
        np.asarray(JSeg.segment_softmax(jnp.asarray(scores), jei[1], n)),
        **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_equals_reference(mode, weighted):
    """Bag ids in no order, and bag 3 empty: 0 for sum and mean, -inf for
    max."""
    rng = np.random.default_rng(2)
    v, d, nnz, bags = 100, 16, 64, 10
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, nnz).astype(np.int32)
    bag = rng.integers(0, bags, nnz).astype(np.int32)
    bag[bag == 3] = 4
    w = rng.random(nnz).astype(np.float32) if weighted else None
    got = TSeg.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(bag),
        bags, mode=mode,
        weights=None if w is None else torch.from_numpy(w)).numpy()
    want = np.asarray(JSeg.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), bags,
        mode=mode, weights=None if w is None else jnp.asarray(w)))
    if mode == "max":
        np.testing.assert_array_equal(got, want)
        assert np.isneginf(got[3]).all()
    else:
        np.testing.assert_allclose(got, want, **TOL)
        assert (got[3] == 0).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_generators_equal_reference(seed):
    for got, want in zip(TGen.erdos_renyi(300, 2000, seed=seed),
                         JGen.erdos_renyi(300, 2000, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(TGen.molecules(4, 9, 14, seed=seed),
                         JGen.molecules(4, 9, 14, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_batching_equals_reference():
    _, _, edges = TGen.molecules(5, 8, 12, seed=3)
    got = TB.block_diagonal(edges, 8)
    assert got.dtype == np.int32 and got.shape == (2, 5 * 12)
    np.testing.assert_array_equal(got, JB.block_diagonal(edges, 8))
    np.testing.assert_array_equal(TB.graph_ids(5, 8), JB.graph_ids(5, 8))
    assert TB.graph_ids(5, 8).dtype == np.int32


def test_to_networkx_equals_reference():
    """Live edges only: one edge pair is tombstoned, another inserted."""
    rng = np.random.default_rng(4)
    n, m = 40, 150
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    ns, nd = np.asarray([3, 7], np.int32), np.asarray([41, 2], np.int32)
    jg = JG.make_graph(src, dst, n, m_cap=m + 2)
    jg = JG.delete_edges(JG.insert_edges(jg, jnp.asarray(ns),
                                         jnp.asarray(nd)),
                         jnp.asarray(src[:1]), jnp.asarray(dst[:1]))
    tg = TG.make_graph(src, dst, n, m_cap=m + 2, device=CPU)
    tg = TG.delete_edges(TG.insert_edges(tg, torch.from_numpy(ns),
                                         torch.from_numpy(nd)),
                         src[:1], dst[:1])
    got, want = TG.to_networkx(tg), JG.to_networkx(jg)
    assert sorted(got.nodes) == sorted(want.nodes) == list(range(42))
    assert sorted(got.edges) == sorted(want.edges)
    assert (int(src[0]), int(dst[0])) not in got.edges
    assert (3, 41) in got.edges


def _same_subgraph(got, want):
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.node_valid, want.node_valid)
    assert got.seed_count == want.seed_count
    assert len(got.blocks) == len(want.blocks)
    for a, b in zip(got.blocks, want.blocks):
        for f in ("src", "dst", "edge_valid"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_and_sample_neighbors_equal_reference(seed):
    n, m = 200, 1500
    src, dst = TGen.power_law(n, m, seed=seed)
    t_csr, j_csr = TS.CSR.from_edges(n, src, dst), JS.CSR.from_edges(n, src,
                                                                     dst)
    for f in ("indptr", "indices"):
        a, b = getattr(t_csr, f), getattr(j_csr, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    batch = np.random.default_rng(seed).choice(n, 16, replace=False)
    got = TS.sample_neighbors(t_csr, batch, [5, 3],
                              rng=np.random.default_rng(9))
    want = JS.sample_neighbors(j_csr, batch, [5, 3],
                               rng=np.random.default_rng(9))
    _same_subgraph(got, want)


def test_reachability_filtered_sample_equals_reference():
    """The port's DBLIndex on the CPU and the JAX DBLIndex filter the same
    draws to the same subgraph; some edges are kept and some dropped."""
    n, m = 300, 900
    src, dst = TGen.dag_like(n, m, seed=0)
    kw = dict(n_cap=n, k=16, k_prime=16, max_iters=64)
    tidx = TIndex.build(TG.make_graph(src, dst, n, device=CPU), device=CPU,
                        **kw)
    jidx = JIndex.build(JG.make_graph(src, dst, n), **kw)
    csr = TS.CSR.from_edges(n, src, dst)
    targets = np.argsort(-np.bincount(dst, minlength=n))[:4].astype(np.int32)
    batch = np.random.default_rng(3).choice(n, 16, replace=False)
    got = TS.reachability_filtered_sample(csr, batch, [5, 3], tidx, targets,
                                          rng=np.random.default_rng(11))
    want = JS.reachability_filtered_sample(csr, batch, [5, 3], jidx,
                                           targets,
                                           rng=np.random.default_rng(11))
    _same_subgraph(got, want)
    kept = sum(int(b.edge_valid.sum()) for b in got.blocks)
    sampled = sum(int(b.edge_valid.sum()) for b in TS.sample_neighbors(
        csr, batch, [5, 3], rng=np.random.default_rng(11)).blocks)
    assert 0 < kept < sampled


def _run_example(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("args", [
    ("examples/quickstart_torch.py", "--device", "cpu"),
    ("examples/dynamic_reachability_torch.py", "--device", "cpu",
     "--n", "400", "--m", "2400", "--rounds", "3", "--queries", "500",
     "--inserts", "20", "--verify", "100")])
def test_example_twin_runs_on_the_cpu(args):
    out = _run_example(*args)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.rstrip().endswith("OK"), out.stdout[-2000:]


def test_example_twin_asks_for_cuda_by_default():
    """Without ``--device`` the twin runs on CUDA; where there is none it
    fails and names the CPU opt-in rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = _run_example("examples/quickstart_torch.py")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert "OK" not in out.stdout
