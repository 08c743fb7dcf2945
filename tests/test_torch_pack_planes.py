"""The label-plane pack (``core.query.pack_labels`` through the op
``repro_torch::pack_label_planes``): on the CPU the op's plain version,
bitwise ``bitset.pack`` of each plane; the kernel's 8-byte multiply on
every pattern; the op's fake implementation, which ``torch.export``
traces with.  The ``chip`` tests hold the kernel
``csrc/pack_planes.cu`` to ``bitset.pack`` on the card and skip without
one; on the card run ``python3 -m pytest -q -m chip
tests/test_torch_pack_planes.py`` (it imports no JAX)."""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import bitset
from repro_torch.core import query as Q
from repro_torch.core.dbl import DBLIndex
from repro_torch.core.graph import make_graph
from repro_torch.graphs.generators import power_law
from repro_torch.kernels.pack_planes import pack_planes as PP
from repro_torch.serve.engine import QueryEngine

KS = (1, 31, 32, 33, 64, 65, 96)
PAIRS = [(k, kp) for k, kp in itertools.product(KS, KS) if k != kp]
NS = (0, 1, 1000)
DTYPES = {"bool": torch.bool, "uint8": torch.uint8}
#: LiveJournal's vertex count, the served n_cap
LJ_N = 4_847_571


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """This file runs no JAX: nothing to reset (overrides the suite's
    fixture, which imports it)."""
    yield


def _planes(rng, n, k, kp, dtype, device="cpu"):
    return tuple(torch.from_numpy(rng.random((n, kk)) < rng.uniform(.1, .6))
                 .to(device=device, dtype=dtype) for kk in (k, k, kp, kp))


class _Ops(TorchDispatchMode):
    """Records the operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,kp", PAIRS)
def test_pack_labels_is_the_op_and_equals_bitset_pack(k, kp, dtype):
    rng = np.random.default_rng(k * 101 + kp)
    for n in NS:
        planes = _planes(rng, n, k, kp, DTYPES[dtype])
        with _Ops() as ops:
            got = Q.pack_labels(*planes)
        assert ops.seen[0] == "repro_torch.pack_label_planes.default"
        assert ops.seen.count(ops.seen[0]) == 1
        for plane, words in zip(planes, got):
            want = bitset.pack(plane)
            assert words.dtype == torch.int32
            assert words.shape == (n, bitset.n_words(plane.shape[1]))
            assert torch.equal(words, want)


def test_the_multiply_packs_every_pattern_of_eight_bytes():
    """The magic of ``bits8`` in the source, read from it, gathers the low
    bit of each of 8 bytes, LSB first, for all 256 patterns of 0/1 bytes."""
    src = (Path(PP.__file__).parents[1] / "csrc" / "pack_planes.cu")
    magic, = re.findall(r"x \* (0x[0-9a-fA-F]+)ull", src.read_text())
    pats = np.arange(256, dtype=np.uint64)
    bytes_ = ((pats[:, None] >> np.arange(8, dtype=np.uint64)) & 1).astype(
        np.uint8)
    x = np.ascontiguousarray(bytes_).view("<u8")[:, 0]
    np.testing.assert_array_equal(
        (x * np.uint64(int(magic, 16))) >> np.uint64(56), pats)


@pytest.mark.parametrize("k,address,mode", [
    (64, 0, PP.VEC8), (64, 8, PP.VEC8), (64, 4, PP.BYTES), (64, 1, PP.BYTES),
    (96, 32, PP.VEC8), (40, 16, PP.VEC8), (40, 4, PP.BYTES),
    (33, 0, PP.BYTES), (8, 0, PP.VEC8), (1, 0, PP.BYTES)])
def test_plane_mode_follows_width_and_alignment(k, address, mode):
    assert PP.plane_mode(k, address) == mode


@pytest.mark.parametrize("k,kp", [(64, 64), (33, 96), (1, 65)])
def test_the_fake_gives_the_word_shapes(k, kp):
    with FakeTensorMode() as mode:
        planes = tuple(mode.from_tensor(torch.zeros(7, kk, dtype=dt))
                       for kk, dt in ((k, torch.bool), (k, torch.bool),
                                      (kp, torch.uint8), (kp, torch.uint8)))
        got = PP.pack_op(*planes)
    assert [tuple(w.shape) for w in got] == \
        [(7, bitset.n_words(kk)) for kk in (k, k, kp, kp)]
    assert all(w.dtype == torch.int32 for w in got)


def test_export_traces_pack_labels_as_one_node():
    class Pack(torch.nn.Module):
        def forward(self, a, b, c, d):
            return tuple(Q.pack_labels(a, b, c, d))

    planes = _planes(np.random.default_rng(3), 50, 64, 33, torch.bool)
    ep = torch.export.export(Pack(), planes)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.pack_label_planes.default") == 1
    for got, plane in zip(ep.module()(*planes), planes):
        assert torch.equal(got, bitset.pack(plane))


def test_an_engine_insert_packs_its_planes_on_the_cpu():
    n, m = 300, 1500
    src, dst = power_law(n, m, seed=4)
    g = make_graph(src, dst, n, m_cap=m + 50, device="cpu")
    idx = DBLIndex.build(g, n_cap=n, k=16, k_prime=40, device="cpu")
    eng = QueryEngine(idx, bfs_chunk=16)
    rng = np.random.default_rng(5)
    with _Ops() as ops:
        nxt = eng.insert(rng.integers(0, n, 20), rng.integers(0, n, 20))
    assert ops.seen.count("repro_torch.pack_label_planes.default") == 1
    for plane, words in zip((nxt.dl_in, nxt.dl_out, nxt.bl_in, nxt.bl_out),
                            nxt.packed):
        assert torch.equal(words, bitset.pack(plane))


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_planes(gen, n, k, kp, dtype, offset, dev):
    """Random 0/1 planes on the card whose bases sit ``offset`` bytes past
    an allocation's start (8-byte or byte alignment)."""
    out = []
    for kk in (k, k, kp, kp):
        buf = torch.empty(n * kk + offset, dtype=torch.uint8, device=dev)
        plane = buf[offset:].view(n, kk)
        plane.copy_(torch.rand((n, kk), generator=gen, device=dev)
                    < torch.rand((), generator=gen, device=dev))
        out.append(plane.view(dtype))
    return tuple(out)


@pytest.mark.chip
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,kp", PAIRS)
def test_the_kernel_equals_bitset_pack_on_the_card(k, kp, dtype, offset):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(k * 101 + kp + offset)
    # LiveJournal's n at the served alignment only
    for n in (1, 1000) + ((LJ_N,) if offset == 0 else ()):
        planes = _card_planes(gen, n, k, kp, DTYPES[dtype], offset, dev)
        before = PP.pack_label_planes.launches
        got = Q.pack_labels(*planes)
        torch.cuda.synchronize()
        assert PP.pack_label_planes.launches == before + 1
        for plane, words in zip(planes, got):
            assert words.device.type == "cuda"
            assert torch.equal(words, bitset.pack(plane)), (n, plane.shape)


@pytest.mark.chip
def test_the_kernel_refuses_what_it_does_not_take():
    dev = _card()
    planes = _planes(np.random.default_rng(6), 100, 64, 64, torch.bool, dev)
    wide = torch.zeros(100, 128, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        Q.pack_labels(wide[:, :64], *planes[1:])
    with pytest.raises(ValueError, match="share a device"):
        Q.pack_labels(*planes[:3], planes[3].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        Q.pack_labels(*planes[:3], planes[3].to(torch.int32))


@pytest.mark.chip
def test_every_pack_labels_call_is_one_launch():
    dev = _card()
    planes = _planes(np.random.default_rng(7), 5000, 64, 64, torch.uint8,
                     dev)
    before = PP.pack_label_planes.launches
    for i in range(1, 4):
        Q.pack_labels(*planes)
        assert PP.pack_label_planes.launches == before + i


@pytest.mark.chip
def test_an_engine_insert_packs_with_the_kernel():
    dev = _card()
    n, m = 6000, 40000
    src, dst = power_law(n, m, seed=1)
    g = make_graph(src, dst, n, m_cap=m + 2000, device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, device=dev)
    eng = QueryEngine(idx, bfs_chunk=64, bfs_kernel=True)
    rng = np.random.default_rng(8)
    before = PP.pack_label_planes.launches
    nxt = eng.insert(rng.integers(0, n, 100), rng.integers(0, n, 100))
    torch.cuda.synchronize()
    assert PP.pack_label_planes.launches == before + 1
    for plane, words in zip((nxt.dl_in, nxt.dl_out, nxt.bl_in, nxt.bl_out),
                            nxt.packed):
        assert torch.equal(words, bitset.pack(plane))


# ------------------------------------------------- the benchmark's reader
def test_the_pack_roofline_reader_reads_the_op_and_its_kernel():
    from reachbench import run as R
    from reachbench import spec
    from reachbench import trace as T

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}

    n, k, kp = LJ_N, 64, 33
    kernel = ("void (anonymous namespace)::pack_planes_kernel("
              "(anonymous namespace)::Planes)")
    events = [x("user_annotation", "reachbench.window", 0, 10_000)]
    for t0 in (100, 5_000):
        events += [x("cpu_op", "repro_torch::pack_label_planes", t0, 20,
                     **{"Input Dims": [[n, k], [n, k], [n, kp], [n, kp]]}),
                   x("kernel", kernel, t0 + 30, 1_000),
                   x("kernel", "other_kernel", t0 + 2_000, 500)]
    run = R.Run(config={})
    run.trace = T.reduce({"traceEvents": events})
    read = spec.reader("kernel.pack_roofline")
    nbytes = n * (2 * k + 2 * kp) + 4 * n * (2 * 2 + 2 * 2)
    assert read(run) == pytest.approx(100 * nbytes / 3.35e12 / 1e-3)
    run.trace = T.reduce({"traceEvents": events[:1] + [
        e for e in events[1:] if "pack" not in e["name"]]})
    assert read(run) is None
