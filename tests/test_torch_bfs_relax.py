"""The BFS relax step (``core.query.relax`` through the op
``repro_torch::bfs_relax``): on the CPU the op's plain version, held
against a dense reference over cutoffs, ragged edges, frontiers and
scatter dtypes; the kernel's byte arithmetic on every byte; the
alignment its wrapper asks of the edge arrays; the op's fake implementation;
the exported BFS round, which takes the op whole with no data-dependent
shape.  The ``chip`` tests hold the kernel ``csrc/bfs_relax.cu`` to the
plain version on the card and skip without one; on the card run
``python3 -m pytest -q -m chip tests/test_torch_bfs_relax.py`` (it
imports no JAX)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import query as Q
from repro_torch.core.dbl import DBLIndex
from repro_torch.core.graph import make_graph
from repro_torch.graphs.generators import power_law
from repro_torch.kernels.bfs_relax import bfs_relax as R
from repro_torch.serve import aot
from repro_torch.serve.engine import QueryEngine

OP = "repro_torch.bfs_relax.default"
QS = (1, 33, 64)
#: the scatter dtypes ``core.query.FRONTIER_DTYPES`` passes
FTYPES = {"int8": torch.int8, "int32": torch.int32}
FRONTIERS = ("empty", "sparse", "full")
N, M = 60, 400


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """This file runs no JAX: nothing to reset (overrides the suite's
    fixture, which imports it)."""
    yield


class _Ops(TorchDispatchMode):
    """Records the operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _dense(frontier, tails, heads, live, m_cut, n_cap):
    """Edge by edge in numpy: OR each live edge's cut tail row into its
    head's row."""
    f, t, h, lv = (x.cpu().numpy() for x in (frontier, tails, heads, live))
    cut = None if m_cut is None else m_cut.cpu().numpy()
    out = np.zeros((n_cap, f.shape[1]), bool)
    for e in np.flatnonzero(lv):
        row = f[t[e]].copy()
        if cut is not None:
            row &= e < cut
        out[h[e]] |= row
    return out


def _edges(rng, n, m, device="cpu"):
    """``relax_edges`` of m raw edges: a tenth of the tails and of the heads
    out of range (clamped, dropped), a fifth of the slots dead."""
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    bad = rng.random(m) < 0.1
    src[bad] = rng.choice([-3, n, n + 7], bad.sum())
    bad = rng.random(m) < 0.1
    dst[bad] = rng.choice([-1, n, 2 * n], bad.sum())
    live = torch.from_numpy(rng.random(m) >= 0.2)
    return Q.relax_edges(torch.from_numpy(src).to(torch.int32).to(device),
                         torch.from_numpy(dst).to(torch.int32).to(device),
                         live.to(device), n)


def _frontier(rng, kind, n, q, device="cpu"):
    if kind == "empty":
        f = np.zeros((n, q), bool)
    elif kind == "full":
        f = np.ones((n, q), bool)
    else:
        f = rng.random((n, q)) < 0.05
        f[rng.random(n) < 0.5] = False
    return torch.from_numpy(f).to(device)


def _cuts(rng, q, m, device="cpu"):
    """Per-lane cutoffs: some below every slot, some inside, some fresh."""
    cut = rng.integers(0, m + 1, q).astype(np.int32)
    cut[rng.random(q) < 0.3] = Q.FRESH_CUT
    cut[0] = 0 if q > 1 else cut[0]
    return torch.from_numpy(cut).to(device)


@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "m_cut"])
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("q", QS)
def test_relax_is_the_op_and_equals_the_step_it_replaces(q, ftype, cut,
                                                         frontier):
    rng = np.random.default_rng(q * 31 + len(ftype) * 7 + cut
                                + 3 * FRONTIERS.index(frontier))
    tails, heads, live = _edges(rng, N, M)
    f = _frontier(rng, frontier, N, q)
    m_cut = _cuts(rng, q, M) if cut else None
    with _Ops() as ops:
        got = Q.relax(f, tails, heads, live, n_cap=N, ftype=FTYPES[ftype],
                      m_cut=m_cut)
    assert ops.seen[0] == OP and ops.seen.count(OP) == 1
    assert got.dtype == torch.bool and got.shape == (N, q)
    np.testing.assert_array_equal(
        got.numpy(), _dense(f, tails, heads, live, m_cut, N))
    if frontier == "empty":
        assert not got.any()


@pytest.mark.parametrize("m", [0, 1])
def test_relax_with_no_live_edge_gives_an_empty_plane(m):
    rng = np.random.default_rng(m)
    tails, heads, live = _edges(rng, N, m)
    live = torch.zeros_like(live)
    got = Q.relax(_frontier(rng, "full", N, 64), tails, heads, live,
                  n_cap=N, m_cut=_cuts(rng, 64, max(m, 1)))
    assert got.shape == (N, 64) and not got.any()


def test_the_byte_trick_marks_every_nonzero_byte():
    """``ones`` in the source, its constants read from it, maps each byte
    of a word to 1 when it is nonzero and to 0 when it is zero: all 256
    values in every byte position, beside bytes that carry (0x7f, 0x80,
    0xff) or not (0x00, 0x01)."""
    src = (Path(R.__file__).parents[1] / "csrc" / "bfs_relax.cu").read_text()
    body = re.search(r"uint32_t ones\(uint32_t x\) \{\s*return (.*?);",
                     src, re.S).group(1)
    mask7, add, shift, one = (int(c, 0) for c in re.fullmatch(
        r"\(\(\(\(x & (0x[0-9a-f]+)u\) \+ (0x[0-9a-f]+)u\) \| x\) >> "
        r"(\d+)\) & (0x[0-9a-f]+)u", body.strip()).groups())
    b = np.arange(256, dtype=np.uint64)
    for pos in range(4):
        for fill in (0x00, 0x01, 0x7f, 0x80, 0xff):
            parts = [np.full(256, fill, np.uint64) for _ in range(4)]
            parts[pos] = b
            x = sum(p << np.uint64(8 * i) for i, p in enumerate(parts))
            y = ((((x & np.uint64(mask7)) + np.uint64(add)) | x)
                 >> np.uint64(shift)) & np.uint64(one)
            want = sum((p != 0).astype(np.uint64) << np.uint64(8 * i)
                       for i, p in enumerate(parts))
            np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("q,address,mode", [
    (64, 0, R.VEC16), (64, 16, R.VEC16), (64, 8, R.BYTES), (64, 1, R.BYTES),
    (32, 256, R.VEC16), (16, 0, R.VEC16), (33, 0, R.BYTES), (1, 0, R.BYTES),
    (48, 32, R.VEC16)])
def test_row_mode_follows_lanes_and_alignment(q, address, mode):
    assert R.row_mode(q, address) == mode


class _PastTheChecks(Exception):
    pass


@pytest.mark.parametrize("name,skip,taken", [
    (None, 0, True), ("tails", 1, False), ("tails", 2, True),
    ("heads", 1, False), ("heads", 2, True), ("live", 1, False),
    ("live", 2, False), ("live", 4, True)])
def test_the_kernel_takes_edge_arrays_at_its_load_alignment(
        monkeypatch, name, skip, taken):
    """The CUDA route refuses an edge array whose base is ``skip`` slots
    past an allocation's start where the kernel's 16-byte (tails, heads)
    or 4-byte (live) loads would not line up; aligned arrays pass every
    check and reach the library (stubbed here)."""
    def load(_name):
        raise _PastTheChecks
    monkeypatch.setattr(R._build, "load", load)
    rng = np.random.default_rng(skip)
    edges = dict(zip(("tails", "heads", "live"), _edges(rng, N, M + skip)))
    edges = {k: x[skip:] if k == name else x[:M] for k, x in edges.items()}
    f = _frontier(rng, "sparse", N, 64)
    if taken:
        with pytest.raises(_PastTheChecks):
            R._relax_cuda(f, **edges, m_cut=None, n_cap=N, ftype=torch.int8)
    else:
        with pytest.raises(ValueError, match=f"{name} must start on a "
                                             f"{R.EDGE_ALIGN[name]}-byte"):
            R._relax_cuda(f, **edges, m_cut=None, n_cap=N, ftype=torch.int8)


@pytest.mark.parametrize("device,waits", [("cpu", True), ("cuda", False),
                                          ("cuda:1", False)])
def test_only_the_plain_relax_waits_on_the_host(device, waits):
    assert R.waits_on_host(device) is waits
    assert R.waits_on_host(torch.device(device)) is waits


@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "m_cut"])
@pytest.mark.parametrize("q", QS)
def test_the_fake_gives_the_plane(q, cut):
    with FakeTensorMode() as mode:
        f = mode.from_tensor(torch.zeros(N, q, dtype=torch.bool))
        e = mode.from_tensor(torch.zeros(M, dtype=torch.int64))
        lv = mode.from_tensor(torch.zeros(M, dtype=torch.bool))
        m_cut = mode.from_tensor(torch.zeros(q, dtype=torch.int32)) \
            if cut else None
        got = R.relax_op(f, e, e, lv, m_cut, N, torch.int8)
    assert tuple(got.shape) == (N, q) and got.dtype == torch.bool


def _engine(frontier_dtype, n=300, m=1400):
    src, dst = power_law(n, m, seed=6)
    g = make_graph(src, dst, n, m_cap=m + 40, device="cpu")
    idx = DBLIndex.build(g, n_cap=n, k=8, k_prime=8, device="cpu")
    return idx, QueryEngine(idx, bfs_chunk=64, bfs_kernel=True,
                            device="cpu", frontier_dtype=frontier_dtype)


@pytest.mark.parametrize("frontier_dtype", ["int8", "int32", "packed"])
def test_the_exported_round_holds_the_op_and_no_data_dependent_shape(
        frontier_dtype):
    idx, eng = _engine(frontier_dtype)
    rng = np.random.default_rng(4)
    n = idx.n_cap
    uu = torch.from_numpy(rng.integers(0, n, 64).astype(np.int32))
    vv = torch.from_numpy(rng.integers(0, n, 64).astype(np.int32))
    m_cut = torch.full((64,), idx.graph.m, dtype=torch.int32)
    _, carry, consts, _ = eng.coalesced_prologue(
        eng._phase_graph(idx.graph), idx.packed, idx.il, uu, vv, m_cut,
        torch.zeros((), dtype=torch.bool))
    ep = torch.export.export(aot._Phase(eng.coalesced_round),
                             (carry, consts))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count(OP) == 1
    assert not any("nonzero" in t or "index_reduce" in t for t in targets)
    # every shape in the program is a number: none waits on the data
    for node in ep.graph.nodes:
        val = node.meta.get("val")
        for v in val if isinstance(val, (tuple, list)) else (val,):
            if isinstance(v, torch.Tensor):
                assert all(isinstance(d, int) for d in v.shape), node
    assert not ep.range_constraints
    got, go = ep.module()(carry, consts)
    want, want_go = eng.coalesced_round(carry, consts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(go) == bool(want_go)


@pytest.mark.parametrize("frontier_dtype", ["int8", "packed"])
def test_an_engine_round_relaxes_once_through_the_op(frontier_dtype):
    idx, eng = _engine(frontier_dtype)
    rng = np.random.default_rng(8)
    rounds = []
    live = eng.coalesced_round

    def counted(carry, consts):
        with _Ops() as ops:
            out = live(carry, consts)
        rounds.append(ops.seen.count(OP))
        return out
    eng.coalesced_round = counted
    eng.query(rng.integers(0, idx.n_cap, 400),
              rng.integers(0, idx.n_cap, 400))
    assert rounds and set(rounds) == {1}


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _offset(x, offset):
    """``x`` copied to a base ``offset`` bytes past an allocation's start."""
    buf = torch.empty(x.numel() * x.element_size() + offset,
                      dtype=torch.uint8, device=x.device)
    out = buf[offset:].view(x.dtype).view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.chip
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "m_cut"])
@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("q", QS + (16, 128))
def test_the_kernel_equals_the_plain_step_on_the_card(q, frontier, cut,
                                                      offset):
    """Every row load mode: the frontier at its allocation's start or a
    byte past it (``row_mode``); the edge arrays as ``relax_edges`` makes
    them, with slot counts no multiple of 4, so a warp's last lane takes a
    ragged run of slots (the scalar loads)."""
    dev = _card()
    rng = np.random.default_rng(q * 13 + FRONTIERS.index(frontier) * 5
                                + 2 * cut + offset)
    for n, m in ((N, M + 3), (5000, 60_001)):
        tails, heads, live = _edges(rng, n, m, dev)
        f = _offset(_frontier(rng, frontier, n, q, dev), offset)
        m_cut = _cuts(rng, q, m, dev) if cut else None
        before = R.bfs_relax.launches
        got = Q.relax(f, tails, heads, live, n_cap=n, m_cut=m_cut)
        torch.cuda.synchronize()
        assert R.bfs_relax.launches == before + 1
        want = R.relax_plain(f, tails, heads, live, m_cut, n)
        assert got.device.type == "cuda" and got.dtype == torch.bool
        assert torch.equal(got, want), (n, m)
        assert torch.equal(got.view(torch.uint8) <= 1,
                           torch.ones_like(got, dtype=torch.bool))


@pytest.mark.chip
def test_the_kernel_refuses_what_it_does_not_take():
    dev = _card()
    rng = np.random.default_rng(9)
    tails, heads, live = _edges(rng, N, M, dev)
    f = _frontier(rng, "sparse", N, 64, dev)
    with pytest.raises(ValueError, match="share a device"):
        Q.relax(f, tails.cpu(), heads, live, n_cap=N)
    with pytest.raises(ValueError, match="bool plane"):
        Q.relax(f.to(torch.int8), tails, heads, live, n_cap=N)
    with pytest.raises(ValueError, match="bool plane"):
        Q.relax(f, tails, heads, live, n_cap=N + 1)
    with pytest.raises(ValueError, match="tails"):
        Q.relax(f, tails.int(), heads, live, n_cap=N)
    with pytest.raises(ValueError, match="live"):
        Q.relax(f, tails, heads, live[:-1], n_cap=N)
    with pytest.raises(ValueError, match="m_cut"):
        Q.relax(f, tails, heads, live, n_cap=N,
                m_cut=torch.zeros(64, dtype=torch.int64, device=dev))


@pytest.mark.chip
def test_an_engine_on_the_card_relaxes_with_the_kernel():
    dev = _card()
    n, m = 6000, 40000
    src, dst = power_law(n, m, seed=1)
    g = make_graph(src, dst, n, m_cap=m + 2000, device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, device=dev)
    eng = QueryEngine(idx, bfs_chunk=64, bfs_kernel=True)
    cpu = QueryEngine(DBLIndex.build(
        make_graph(src, dst, n, m_cap=m + 2000, device="cpu"), n_cap=n,
        k=64, k_prime=64, device="cpu"), bfs_chunk=64, bfs_kernel=True,
        device="cpu")
    rng = np.random.default_rng(3)
    u, v = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    before = R.bfs_relax.launches
    got = eng.query(u, v)
    assert R.bfs_relax.launches > before
    np.testing.assert_array_equal(got, cpu.query(u, v))
