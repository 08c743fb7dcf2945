"""The streamed kernels' plain versions (the CPU path of the port's
``dbl_query_verdicts_streamed`` and ``bfs_admit_plane_streamed``) against
the JAX streamed Pallas kernels in interpret mode, bitwise, and the
streaming + interval-plane rule (``StreamILFallbackWarning``)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as JB
from repro.core import query as JQ
from repro.kernels.bfs_prune.ops import admit_plane as j_admit_plane
from repro.kernels.dbl_query.ops import verdicts_device as j_verdicts_device
from repro_torch.core import bitset as TB
from repro_torch.core import query as TQ
from repro_torch.kernels.bfs_prune import bfs_prune as T_bfs
from repro_torch.kernels.bfs_prune.ops import admit_plane as t_admit_plane
from repro_torch.kernels.dbl_query import dbl_query as T_dbl
from repro_torch.kernels.dbl_query import ops as T_ops
from repro_torch.serve.engine import QueryEngine as TEngine


def _planes(rng, n, k, kp):
    dens = rng.uniform(0.05, 0.3)
    bits = [rng.random((n, kk)) < dens for kk in (k, k, kp, kp)]
    for b in bits[2:]:
        b[rng.random(n) < 0.3] = False   # empty BL rows: containment holds
    jp = JQ.PackedLabels(*(JB.pack(jnp.asarray(b)) for b in bits))
    tp = TQ.PackedLabels(*(TB.pack(torch.from_numpy(b)) for b in bits))
    return jp, tp


def _ids(rng, n, q):
    u = rng.integers(0, n, q).astype(np.int32)
    v = rng.integers(0, n, q).astype(np.int32)
    v[::5] = u[::5]                                   # self-queries
    return u, v


def _cutoffs(rng, q, ncut):
    kw_j, kw_t = {}, {}
    if ncut >= 1:
        m_cut = rng.integers(0, 9, q).astype(np.int32)
        kw_j.update(m_cut=jnp.asarray(m_cut), m_total=jnp.int32(4))
        kw_t.update(m_cut=torch.from_numpy(m_cut), m_total=4)
    if ncut == 2:
        d_cut = rng.integers(0, 3, q).astype(np.int32)
        kw_j.update(d_cut=jnp.asarray(d_cut), d_total=jnp.int32(1))
        kw_t.update(d_cut=torch.from_numpy(d_cut), d_total=1)
    return kw_j, kw_t


VERDICT_CASES = [
    # q, k, k', ncut, out dtype
    (1, 32, 64, 0, "int32"),
    (37, 40, 96, 1, "int8"),
    (300, 64, 32, 2, "int32"),
    (37, 64, 64, 2, "int8"),
    (300, 32, 64, 0, "int8"),
    (129, 40, 96, 1, "int32"),
]


@pytest.mark.parametrize("q,k,kp,ncut,out", VERDICT_CASES)
def test_streamed_verdicts_match_pallas_streamed(q, k, kp, ncut, out):
    rng = np.random.default_rng(q * 11 + k + kp + ncut)
    n = 61
    jp, tp = _planes(rng, n, k, kp)
    u, v = _ids(rng, n, q)
    kw_j, kw_t = _cutoffs(rng, q, ncut)
    jdt = jnp.int8 if out == "int8" else jnp.int32
    tdt = torch.int8 if out == "int8" else torch.int32
    want = np.asarray(j_verdicts_device(
        jp, jnp.asarray(u), jnp.asarray(v), q_block=128, interpret=True,
        out_dtype=jdt, streaming=True, **kw_j))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    cut = T_dbl.freshness_rows(**kw_t)
    assert (0 if cut is None else cut.shape[0]) == ncut
    got = T_dbl.verdicts_streamed_plain(*tp, tu, tv, cut, out_dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper and the ops route take the plain version for CPU tensors,
    # and the streamed contract is the grid kernel's
    np.testing.assert_array_equal(T_dbl.dbl_query_verdicts_streamed(
        *tp, tu, tv, **kw_t, out_dtype=tdt).numpy(), want)
    np.testing.assert_array_equal(T_ops.verdicts_device(
        tp, tu, tv, **kw_t, out_dtype=tdt, streaming=True).numpy(), want)
    np.testing.assert_array_equal(T_ops.verdicts_device(
        tp, tu, tv, **kw_t, out_dtype=tdt).numpy(), want)


ADMIT_CASES = [
    # n, q, k, k', ncut
    (37, 33, 32, 64, 0),
    (130, 1, 64, 32, 1),
    (130, 100, 40, 96, 2),
    (70, 64, 64, 64, 2),
    (37, 5, 96, 40, 1),
]


@pytest.mark.parametrize("n,q,k,kp,ncut", ADMIT_CASES)
def test_streamed_admit_matches_pallas_streamed(n, q, k, kp, ncut):
    rng = np.random.default_rng(n * 3 + q + k + ncut)
    jp, tp = _planes(rng, n, k, kp)
    u, v = _ids(rng, n, q)
    u[::7] = n                       # dead lanes: clamped to the last row
    kw_j, kw_t = _cutoffs(rng, q, ncut)
    want = np.asarray(j_admit_plane(
        jp, jnp.asarray(u), jnp.asarray(v), n_block=64, q_block=64,
        interpret=True, out_dtype=jnp.int8, streaming=True, **kw_j))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    args = (tp.bl_in, tp.bl_out, tp.dl_in, tp.dl_out, tu, tv)
    cut = T_dbl.freshness_rows(**kw_t)
    fresh = None if cut is None else cut.all(0).to(torch.int32)
    got = T_bfs.admit_streamed_plain(*args, fresh)
    assert got.dtype == torch.int8 and got.shape == (n, q)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T_bfs.bfs_admit_plane_streamed(
        *args, **kw_t, n_block=12).numpy(), want)
    np.testing.assert_array_equal(t_admit_plane(
        tp, tu, tv, **kw_t, out_dtype=torch.int8, device="cpu",
        streaming=True).numpy(), want)
    np.testing.assert_array_equal(
        T_bfs.bfs_admit_plane(*args, **kw_t).numpy(), want)


def test_streamed_wrappers_reject_bad_arguments():
    rng = np.random.default_rng(3)
    _, tp = _planes(rng, 20, 32, 32)
    u = torch.zeros(4, dtype=torch.int32)
    args = (tp.bl_in, tp.bl_out, tp.dl_in, tp.dl_out, u, u)
    for nb in (0, 6):
        with pytest.raises(ValueError, match="n_block"):
            T_bfs.bfs_admit_plane_streamed(*args, n_block=nb)
    with pytest.raises(ValueError, match="needs the edge-count"):
        T_bfs.bfs_admit_plane_streamed(*args, d_cut=u, d_total=1)
    with pytest.raises(ValueError, match="with its total"):
        T_dbl.dbl_query_verdicts_streamed(*tp, u, u, m_cut=u)
    with pytest.raises(ValueError, match="out_dtype"):
        T_dbl.dbl_query_verdicts_streamed(*tp, u, u, out_dtype=torch.int16)
    # the persistent grid's chunk: n spread over the blocks, a multiple
    # of 4 within [4, 1024] rows, smaller where the ring would not fit
    assert T_bfs.pick_n_block(60_000, 132, 2, 2) == 456
    assert T_bfs.pick_n_block(10, 132, 2, 2) == 4
    assert T_bfs.pick_n_block(10**8, 132, 2, 2) == 1024
    assert T_bfs.pick_n_block(10**8, 132, 40, 40) == 240


def _il(rng, n):
    il = [rng.integers(-50, 50, (n, 6)).astype(np.int32) for _ in range(2)]
    return tuple(jnp.asarray(x) for x in il), \
        tuple(torch.from_numpy(x) for x in il)


def test_streaming_il_warns_per_dispatch_and_equals_grid():
    rng = np.random.default_rng(9)
    n, q = 50, 70
    jp, tp = _planes(rng, n, 40, 64)
    u, v = _ids(rng, n, q)
    il_j, il_t = _il(rng, n)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    want = np.asarray(j_verdicts_device(jp, jnp.asarray(u), jnp.asarray(v),
                                        il=il_j, q_block=128,
                                        interpret=True))
    for _ in range(2):          # every dispatch warns: no process latch
        with pytest.warns(T_ops.StreamILFallbackWarning,
                          match="grid kernel"):
            got = T_ops.verdicts_device(tp, tu, tv, il=il_t,
                                        streaming=True)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        T_ops.verdicts_device(tp, tu, tv, il=il_t).numpy(), want)
    # the category filters on its own; other warnings stay errors
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warnings.simplefilter("ignore", T_ops.StreamILFallbackWarning)
        T_ops.query_verdicts(tp, u, v, il=il_t, device="cpu",
                             streaming=True)


def test_streaming_engine_warns_once_per_engine():
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import power_law
    n = 128
    src, dst = power_law(n, 700, seed=41)
    idx = DBLIndex.build(make_graph(src, dst, n, device="cpu"), n_cap=n,
                         k=8, k_prime=8, max_iters=64, device="cpu")
    rng = np.random.default_rng(43)
    _, il_t = _il(rng, n)
    u = torch.from_numpy(rng.integers(0, n, 150).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, n, 150).astype(np.int32))
    grid = TEngine(idx, bfs_chunk=64, max_iters=64)
    want = [grid.label_phase(idx.packed, a, b, False, il=il_t)
            for a, b in ((u, v), (v, u))]
    for _ in range(2):          # a new engine signals again
        eng = TEngine(idx, bfs_chunk=64, max_iters=64, streaming=True)
        with pytest.warns(T_ops.StreamILFallbackWarning,
                          match="grid kernel"):
            first = eng.label_phase(idx.packed, u, v, False, il=il_t)
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # the second stays silent
            second = eng.label_phase(idx.packed, v, u, False, il=il_t)
        for got, exp in zip((first, second), want):
            for a, b in zip(got, exp):
                assert torch.equal(a, b)


# --------------------------------------- the streamed verdicts' geometry
@pytest.mark.parametrize("q", [1, 37, 64, 4_224, 20_032, 33_793, 200_003])
def test_streamed_verdict_geometry_covers_every_lane_once(q):
    """The persistent walk (block b takes chunks b, b + blocks, ...)
    writes each lane exactly once, with at most one block per SM, for
    ragged Q, one wave and many chunks a block."""
    for sms in (1, 7, 132):
        for wd, wb in ((2, 2), (4, 1), (5, 5)):
            g = T_dbl.verdict_geometry(q, wd, wb, sms, streamed=True,
                                       aligned=True)
            assert g.blocks <= sms
            assert g.threads % 32 == 0 and 32 <= g.threads <= T_dbl.MAX_CHUNK
            cover = T_dbl.verdict_coverage(g, q)
            assert (cover.sum(0) == 1).all(), (q, sms, g)
            assert (cover.sum(1) > 0).all()      # every block has work


def test_streamed_verdict_geometry_one_chunk_a_block_in_one_wave():
    """At the LJ label batch on 132 SMs no block computes two chunks in
    series; at Q = 200 003 every block walks three or more."""
    g = T_dbl.verdict_geometry(20_032, 2, 2, 132, streamed=True,
                               aligned=True)
    assert (g.blocks, g.threads, g.instance) == (126, 160, (2, 2, True))
    steps = -(-T_dbl.verdict_coverage(g, 20_032).sum(1) // g.threads)
    assert steps.max() == 1
    g = T_dbl.verdict_geometry(200_003, 2, 2, 132, streamed=True,
                               aligned=True)
    assert g.blocks == 132
    steps = -(-T_dbl.verdict_coverage(g, 200_003).sum(1) // g.threads)
    assert steps.min() >= 3
    # unaligned planes take the scalar instance
    assert T_dbl.verdict_geometry(
        20_032, 2, 2, 132, streamed=True, aligned=False).instance == \
        (2, 2, False)
