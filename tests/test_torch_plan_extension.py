"""The port's shard plans on the host, held bit for bit against the JAX
package's: ``_normalize_batch``, ``_build_dir`` and ``_extend_dir`` on
the same numpy inputs give the same ``(d, E_pad)`` buckets and
``(d, d, H)`` halo lists, with d = 4.  In-process, no process group: the
plans are host tables, and a mesh handle that runs no collective stands in
for the ranks when a plan's device rows are checked.

Twins of ``tests/distributed/run_plan_extension.py``'s
``plan_stream_equivalence``, ``early_outs_and_dedupe`` and
``catchup_window_reinsert`` (its table-level half; the rebuild half runs
over gloo in ``test_torch_sharded_planes.py``), of the degenerate plans of
``run_sharded_planes.py``'s ``degenerate_halo_or_noop`` (zero cut edges,
the empty edge set, ``H == halo_granule``, the pad sentinel), and of the
kept extents.  The reference's check that in-granule extensions compile
nothing has no analogue: the port has no jit cache."""
import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import planes as JPL
from repro.core import propagate as JP
from repro_torch.core import distributed as TD
from repro_torch.core import halo as TH
from repro_torch.core import planes as TPL
from repro_torch.core import propagate as TP
from repro_torch.graphs.generators import power_law
from tests.test_torch_sharded_planes import clean_batch

D = 4
HOST = ("e_slot", "e_recv", "e_gid", "e_valid", "h_send", "h_valid")


def _mesh(rank=0):
    return TD.VertexMesh(None, rank, D, torch.device("cpu"))


@contextlib.contextmanager
def _world_of_one():
    """The vertex mesh of a one-rank gloo world in this process, taken
    down again on the way out."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield TD.vertex_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def assert_host_equal(port, ref_host, what):
    """Every table of a ``_DirHost``, values and dtypes, bit for bit."""
    for f in HOST:
        a, b = getattr(port, f), getattr(ref_host, f)
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")


def ref_build(push, recv, m, n_loc, eg, hg, hub_count=0):
    return JPL._build_dir(push, recv, m, n_loc, D, eg, hg, hub_count)


def ref_extend(dp, push, recv, gid, n_loc, eg, hg):
    """The reference's extension of a direction, with its device upload
    skipped: ``finish`` takes the numpy tables as they are."""
    parts, finish = JPL._extend_dir(dp, push, recv, gid, n_loc, D, eg, hg)
    return finish(parts)


def decoded_push(host, n_loc):
    """(d, E_pad) global pushing vertex per bucket entry, independent of
    the order of the halo lists."""
    es, hs = host.e_slot.astype(np.int64), host.h_send
    H = hs.shape[2]
    out = np.zeros_like(es)
    for t in range(D):
        sl = es[t]
        local = sl < n_loc
        out[t][local] = t * n_loc + sl[local]
        off = sl[~local] - n_loc
        out[t][~local] = (off // H) * n_loc + hs[off // H, t, off % H]
    return out


def assert_equiv_scratch(ext, scratch, n_loc, what):
    """Extended tables against from-scratch ones: buckets and segment
    flags bit-identical, the halo routing the same map and sets."""
    assert ext.e_recv.shape == scratch.e_recv.shape, what
    assert ext.h_send.shape == scratch.h_send.shape, what
    for f in ("e_recv", "e_gid", "e_valid"):
        np.testing.assert_array_equal(getattr(ext, f), getattr(scratch, f),
                                      err_msg=f"{what}: {f}")
    for a, b in zip(TPL._segment_flags(ext.e_recv),
                    TPL._segment_flags(scratch.e_recv)):
        np.testing.assert_array_equal(a, b, err_msg=what)
    val = ext.e_valid
    np.testing.assert_array_equal(decoded_push(ext, n_loc)[val],
                                  decoded_push(scratch, n_loc)[val],
                                  err_msg=what)
    for s in range(D):
        for t in range(D):
            a = ext.h_send[s, t][ext.h_valid[s, t]].tolist()
            b = scratch.h_send[s, t][scratch.h_valid[s, t]].tolist()
            assert set(a) == set(b) and len(a) == len(set(a)), (what, s, t)


@pytest.mark.parametrize("seed,n,m,eg,hg", [
    (7, 256, 900, 1024, 64), (7, 256, 900, 32, 4), (3, 64, 200, 1024, 64),
    (11, 512, 3000, 256, 16)])
def test_build_dir_equals_reference(seed, n, m, eg, hg):
    src, dst = power_law(n, m, seed=seed)
    n_loc = n // D
    for push, recv in ((src, dst), (dst, src)):
        port = TPL._build_dir(push, recv, m, n_loc, D, eg, hg)
        ref = ref_build(push, recv, m, n_loc, eg, hg)
        assert_host_equal(port, ref.host, f"seed {seed}")
        start, tail = TPL._segment_flags(port.e_recv)
        np.testing.assert_array_equal(start, np.asarray(ref.e_start))
        np.testing.assert_array_equal(tail, np.asarray(ref.e_tail))


@pytest.mark.parametrize("dedupe", [True, False])
def test_normalize_batch_equals_reference(dedupe):
    batches = [(np.array([1, 1, 1, 17, 17, 40, 2, 2]),
                np.array([33, 33, 33, 49, 49, 40, 60, 60])),
               (np.array([5, 5, 9]), np.array([5, 5, 9])),
               (np.zeros(0, np.int32), np.zeros(0, np.int32)),
               tuple(np.random.default_rng(4).integers(0, 64, (2, 50)))]
    for ns, nd in batches:
        got = TPL._normalize_batch(ns, nd, 1000, dedupe)
        want = JPL._normalize_batch(ns, nd, 1000, dedupe)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("eg,hg,what", [(1024, 64, "in-granule"),
                                        (32, 4, "spill")])
def test_plan_stream_equivalence(eg, hg, what):
    """A random insert stream: the port's extended tables equal the
    reference's bit for bit every round, and a from-scratch build's up to
    the order of the halo lists; default granules keep the extents, tiny
    granules spill to the from-scratch extents."""
    n, m0 = 256, 900
    src, dst = power_law(n, m0, seed=7)
    n_loc = n // D
    rng = np.random.default_rng(11)
    port = {"f": TPL._build_dir(src, dst, m0, n_loc, D, eg, hg),
            "b": TPL._build_dir(dst, src, m0, n_loc, D, eg, hg)}
    ref = {"f": ref_build(src, dst, m0, n_loc, eg, hg),
           "b": ref_build(dst, src, m0, n_loc, eg, hg)}
    e0 = (port["f"].e_recv.shape, port["f"].h_send.shape)
    asrc, adst, spilled = src, dst, False
    for r in range(6):
        ns, nd = clean_batch(rng, n, int(rng.integers(8, 64)))
        s, d, gid, raw = TPL._normalize_batch(ns, nd, len(asrc))
        asrc = np.concatenate([asrc, ns])
        adst = np.concatenate([adst, nd])
        for key, (push, recv, ap, ar) in {
                "f": (s, d, asrc, adst), "b": (d, s, adst, asrc)}.items():
            port[key] = TPL._extend_dir(port[key], push, recv, gid, n_loc,
                                        D, eg, hg)
            ref[key] = ref_extend(ref[key], push, recv, gid, n_loc, eg, hg)
            assert_host_equal(port[key], ref[key].host, f"{what} {r}")
            scratch = TPL._build_dir(ap, ar, len(ap), n_loc, D, eg, hg)
            assert_equiv_scratch(port[key], scratch, n_loc, f"{what} {r}")
        spilled |= (port["f"].e_recv.shape, port["f"].h_send.shape) != e0
    assert spilled == (what == "spill")


def test_early_outs_and_dedupe():
    """A zero-cut batch keeps the very halo arrays (host and device); a
    batch that normalizes to nothing only advances ``m``; duplicates and
    self-loops enter the buckets once, at their first slot."""
    n, m0 = 64, 200
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, m0).astype(np.int32)
    dst = rng.integers(0, n, m0).astype(np.int32)
    n_loc = n // D
    plan = TPL.shard_plan(src, dst, m0, n, _mesh(1))

    ns = np.arange(0, n_loc - 1, dtype=np.int32)
    nd = ns + 1
    p2 = TPL.extend_plan(plan, ns, nd)
    assert p2.m == plan.m + len(ns)
    for name in ("fwd", "bwd"):
        de, d0 = getattr(p2, name), getattr(plan, name)
        assert de.host.h_send is d0.host.h_send
        assert de.h_send is d0.h_send and de.h_valid is d0.h_valid
    scratch = TPL._build_dir(np.concatenate([src, ns]),
                             np.concatenate([dst, nd]), m0 + len(ns), n_loc,
                             D, 1024, 64)
    assert_equiv_scratch(p2.fwd.host, scratch, n_loc, "zero-cut")

    p3 = TPL.extend_plan(p2, np.array([5, 5, 9]), np.array([5, 5, 9]))
    assert p3.m == p2.m + 3
    assert p3.fwd is p2.fwd and p3.bwd is p2.bwd

    ns = np.array([1, 1, 1, 17, 17, 40, 2, 2], np.int32)
    nd = np.array([33, 33, 33, 49, 49, 40, 60, 60], np.int32)
    p4 = TPL.extend_plan(p3, ns, nd)
    base = p3.m
    for name in ("fwd", "bwd"):
        h = getattr(p4, name).host
        gids = h.e_gid[h.e_valid]
        assert np.sort(gids[gids >= base]).tolist() == \
            [base, base + 3, base + 6]


def test_catchup_window_reinsert_tables():
    """A window spanning a batch that ends with (a, b) and a batch that
    re-inserts (a, b): extended with ``dedupe=False`` it routes both slots
    and equals the reference's extension bit for bit and a from-scratch
    plan's buckets."""
    n, m = 256, 1200
    src, dst = power_law(n, m, seed=29)
    a, b = 3, n - 5
    keep = ~((src == a) & (dst == b))
    src, dst = src[keep], dst[keep]
    m0 = len(src)
    n_loc = n // D
    rng = np.random.default_rng(31)
    ns1, nd1 = clean_batch(rng, n, 16)
    keep = ~((ns1 == a) & (nd1 == b))
    ns = np.concatenate([ns1[keep], [a], [a]]).astype(np.int32)
    nd = np.concatenate([nd1[keep], [b], [b]]).astype(np.int32)
    gid_dead, gid_live = m0 + len(ns) - 2, m0 + len(ns) - 1
    s, d, gid, raw = TPL._normalize_batch(ns, nd, m0, dedupe=False)
    assert raw == len(s) == len(ns)
    asrc, adst = np.concatenate([src, ns]), np.concatenate([dst, nd])
    for push, recv, ap, ar in ((s, d, asrc, adst), (d, s, adst, asrc)):
        port = TPL._extend_dir(
            TPL._build_dir(ap[:m0], ar[:m0], m0, n_loc, D, 1024, 64),
            push, recv, gid, n_loc, D, 1024, 64)
        ref = ref_extend(ref_build(ap[:m0], ar[:m0], m0, n_loc, 1024, 64),
                         push, recv, gid, n_loc, 1024, 64)
        assert_host_equal(port, ref.host, "catch-up")
        scratch = TPL._build_dir(ap, ar, len(ap), n_loc, D, 1024, 64)
        assert_equiv_scratch(port, scratch, n_loc, "catch-up")
        gids = set(port.e_gid[port.e_valid].tolist())
        assert gid_dead in gids and gid_live in gids
    # the per-batch dedupe would keep only the dead (lower) slot
    kept = TPL._normalize_batch(ns, nd, m0)[2]
    assert gid_dead in kept and gid_live not in kept


@pytest.mark.parametrize("what", ["local-only", "empty"])
def test_degenerate_plans(what):
    """No cut edge, or no edge: H is the halo granule, no halo slot is
    valid, and every padding entry carries the sentinel n_loc; equal to
    the reference's tables."""
    n = 64
    n_loc = n // D
    rng = np.random.default_rng(12)
    src = rng.integers(0, 16, 80).astype(np.int32)
    dst = rng.integers(0, 16, 80).astype(np.int32)
    m = len(src) if what == "local-only" else 0
    plan = TPL.shard_plan(src, dst, m, n, _mesh(0))
    for name, (push, recv) in (("fwd", (src, dst)), ("bwd", (dst, src))):
        h = getattr(plan, name).host
        assert h.h_valid.sum() == 0 and h.h_send.shape[2] == 64
        assert (h.e_recv[~h.e_valid] == n_loc).all()
        assert_host_equal(h, ref_build(push, recv, m, n_loc, 1024, 64).host,
                          what)


def test_kept_extents_and_device_rows():
    """Extents hold while a stream fits the granule-rounded tails and
    spill to the from-scratch extents when it does not; each rank's
    device rows are its rows of the host tables, with the segment flags
    derived from them."""
    n, m0 = 256, 900
    src, dst = power_law(n, m0, seed=7)
    rng = np.random.default_rng(5)
    plans = [TPL.shard_plan(src, dst, m0, n, _mesh(r), edge_granule=64,
                            halo_granule=8) for r in range(D)]
    asrc, adst = src, dst
    shapes = []
    for _ in range(8):
        ns, nd = clean_batch(rng, n, 40)
        plans = [TPL.extend_plan(p, ns, nd) for p in plans]
        asrc, adst = np.concatenate([asrc, ns]), np.concatenate([adst, nd])
        scratch = TPL.shard_plan(asrc, adst, len(asrc), n, _mesh(0),
                                 edge_granule=64, halo_granule=8)
        for name in ("fwd", "bwd"):
            h = getattr(plans[0], name).host
            hs = getattr(scratch, name).host
            assert h.e_recv.shape == hs.e_recv.shape
            assert h.h_send.shape == hs.h_send.shape
        shapes.append(plans[0].fwd.host.e_recv.shape)
    assert len(set(shapes)) > 1 and shapes[0] == shapes[1]
    assert plans[0].edge_granule == 64 and plans[0].halo_granule == 8
    for r, p in enumerate(plans):
        for name in ("fwd", "bwd"):
            dp = getattr(p, name)
            start, tail = TPL._segment_flags(dp.host.e_recv)
            for f, want in (("e_slot", dp.host.e_slot[r]),
                            ("e_recv", dp.host.e_recv[r]),
                            ("e_gid", dp.host.e_gid[r]),
                            ("e_valid", dp.host.e_valid[r]),
                            ("h_send", dp.host.h_send[r]),
                            ("h_valid", dp.host.h_valid[r]),
                            ("e_start", start[r]), ("e_tail", tail[r])):
                np.testing.assert_array_equal(getattr(dp, f).numpy(), want)


def test_layout_and_options_refused_like_the_reference():
    for bad in (dict(kind="ring"), dict(shards=2)):
        with pytest.raises(ValueError) as want:
            JPL.PlaneLayout(**bad)
        with pytest.raises(ValueError) as got:
            TPL.PlaneLayout(**bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="rank 4 outside 4"):
        TPL.PlaneLayout("vertex_sharded", shards=4, rank=4)
    lay = TPL.vertex_layout(_mesh(2))
    assert (lay.kind, lay.axis, lay.shards, lay.rank, lay.sharded) == (
        "vertex_sharded", JPL.VERTEX_AXIS, 4, 2, True)
    assert TPL._check_rows(64, lay) == 16
    with pytest.raises(ValueError) as got:
        TPL._check_rows(66, lay)
    with pytest.raises(ValueError) as want:
        JPL._check_rows(66, JPL.PlaneLayout("vertex_sharded", shards=4))
    assert str(got.value) == str(want.value)
    assert TP.HALO_MODES == JP.HALO_MODES
    with pytest.raises(ValueError) as got:
        TP.check_halo_mode("nope")
    with pytest.raises(ValueError) as want:
        JP.check_halo_mode("nope")
    assert str(got.value) == str(want.value)
    src, dst = power_law(64, 200, seed=1)
    # the hub lane's plan tables equal the reference's; the sparse halo's
    # options run (a world of one gloo rank: the fixpoint's collectives
    # need a group) and give the dense fixpoint's rows and rounds
    hplan = TPL.shard_plan(src, dst, 200, 64, _mesh(0), hub_count=4)
    assert hplan.hub_count == 4
    for name, (push, recv) in (("fwd", (src, dst)), ("bwd", (dst, src))):
        want = ref_build(push, recv, 200, 16, 1024, 64, 4).host
        assert_host_equal(getattr(hplan, name).host, want, name)
        for f in ("h_hub", "hub_slot", "hubs"):
            np.testing.assert_array_equal(
                getattr(getattr(hplan, name).host, f), getattr(want, f))
    with _world_of_one() as one:
        plan = TPL.shard_plan(src, dst, 200, 64, one)
        x = torch.zeros((64, 8), dtype=torch.uint8)
        x[torch.arange(8), torch.arange(8)] = 1
        fr = x.any(1)
        live = torch.ones(200, dtype=torch.bool)
        want, it = TPL.halo_propagate(plan, x, fr, live, max_iters=32)
        tel = TH.HaloTelemetry()
        for kw in (dict(halo_mode="sparse"), dict(telemetry=tel),
                   dict(halo_caps=(8,)),
                   dict(halo_mode="sparse", telemetry=tel, halo_caps=(8,))):
            got, it2 = TPL.halo_propagate(plan, x, fr, live, max_iters=32,
                                          **kw)
            assert torch.equal(got, want) and it2 == it, kw
        # one rank has no pairs: dense bytes are zero, sparse rounds local
        t = tel.as_dict()
        assert it > 0 and t["fixpoints"] == 2 and t["halo_rounds"] == 2 * it
        assert t["local_rounds"] == it and t["dense_rounds"] == it
        assert t["halo_bytes"] == it * 4
    with pytest.raises(ValueError, match="OR monoid only"):
        TPL.halo_propagate(plan, x.int(), fr, live, monoid="min",
                           plane_repr="packed")
    with pytest.raises(ValueError, match="unknown monoid"):
        TPL.halo_propagate(plan, x, fr, live, monoid="max")
