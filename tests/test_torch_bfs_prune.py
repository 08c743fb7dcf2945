"""The admit-plane kernel's plain version (the CPU path of the port's
``bfs_admit_plane``) against the JAX Pallas kernel in interpret mode and
its reference, bitwise; the kernels' freshness folding, launch geometry
and build cache key."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as JB
from repro.core import query as JQ
from repro.kernels.bfs_prune.ops import admit_plane as j_admit_plane
from repro.kernels.bfs_prune.ref import admit_ref
from repro_torch.core import bitset as TB
from repro_torch.core import query as TQ
from repro_torch.kernels import _build
from repro_torch.kernels.bfs_prune.bfs_prune import (
    admit_coverage, admit_geometry, admit_plain, admit_streamed_plain,
    lanes_per_thread)
from repro_torch.kernels.bfs_prune.ops import admit_plane as t_admit_plane

N = 150   # not a multiple of the reference's 64-vertex test block


def _planes(rng, k, kp):
    bits = [rng.random((N, kk)) < 0.15 for kk in (k, k, kp, kp)]
    for b in bits[2:]:
        b[rng.random(N) < 0.4] = False
    jp = JQ.PackedLabels(*(JB.pack(jnp.asarray(b)) for b in bits))
    tp = TQ.PackedLabels(*(TB.pack(torch.from_numpy(b)) for b in bits))
    return jp, tp


@pytest.mark.parametrize("q,k,kp,cut,il", [
    (1, 32, 64, "none", False),
    (33, 40, 96, "m", False),
    (128, 64, 64, "md", False),
    (33, 64, 32, "md", True),
    (128, 40, 40, "none", True),
])
def test_plain_admit_matches_pallas_and_ref(q, k, kp, cut, il):
    rng = np.random.default_rng(q + k * 3 + kp)
    jp, tp = _planes(rng, k, kp)
    u = rng.integers(0, N, q).astype(np.int32)
    v = rng.integers(0, N, q).astype(np.int32)
    u[-1] = N                                   # a dead residue lane
    args_j, args_t = [], []
    if cut in ("m", "md"):
        m_cut = rng.integers(90, 110, q).astype(np.int32)
        args_j += [jnp.asarray(m_cut), jnp.int32(100)]
        args_t += [torch.from_numpy(m_cut), 100]
    else:
        args_j += [None, None]
        args_t += [None, None]
    if cut == "md":
        d_cut = rng.integers(0, 3, q).astype(np.int32)
        args_j += [jnp.asarray(d_cut), jnp.int32(1)]
        args_t += [torch.from_numpy(d_cut), 1]
    else:
        args_j += [None, None]
        args_t += [None, None]
    il_j = il_t = il_on = None
    if il:
        planes = [rng.integers(-30, 30, (N, 4)).astype(np.int32)
                  for _ in range(2)]
        il_j = tuple(jnp.asarray(x) for x in planes)
        il_t = tuple(torch.from_numpy(x) for x in planes)
        il_on = np.arange(q) % 3 != 0
    want = np.asarray(j_admit_plane(
        jp, jnp.asarray(u), jnp.asarray(v), *args_j, il_j,
        None if il_on is None else jnp.asarray(il_on),
        n_block=64, q_block=32, interpret=True, out_dtype=jnp.int8))
    got = t_admit_plane(tp, torch.from_numpy(u), torch.from_numpy(v),
                        *args_t, il_t,
                        None if il_on is None else torch.from_numpy(il_on),
                        out_dtype=torch.int8, device="cpu")
    assert got.shape == (N, q) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's plain version against the reference's admit_ref
    plain = admit_plain(tp.bl_in, tp.bl_out, tp.dl_in, tp.dl_out,
                        torch.from_numpy(u), torch.from_numpy(v), *args_t)
    uc = np.minimum(u, N - 1)
    vc = np.minimum(v, N - 1)
    cuts = [None if a is None else
            (jnp.reshape(a, (1, -1)) if a.ndim else a) for a in args_j]
    ref = admit_ref(jp.bl_in.T, jp.bl_out.T, jp.dl_in.T, jp.bl_in[vc].T,
                    jp.bl_out[vc].T, jp.dl_out[uc].T, *cuts,
                    out_dtype=jnp.int8)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))
    # and the core torch admit plane the plain version builds on, against
    # the reference's core, where no cutoff applies
    if cut == "none" and not il:
        core = TQ._admit_plane(tp, torch.from_numpy(u), torch.from_numpy(v),
                               N)
        want_core = JQ._admit_plane(jp, jnp.asarray(u), jnp.asarray(v), N)
        np.testing.assert_array_equal(core.numpy(), np.asarray(want_core))


# --------------------------------------------------- freshness folding
@pytest.mark.parametrize("cut", ["none", "m", "md"])
@pytest.mark.parametrize("seed", [0, 1])
def test_folded_freshness_equals_gated_plane(cut, seed):
    """The kernels stage a stale lane's DL_out(u_q) words as zeros and drop
    the gate; that plane equals the gated one, through both plain versions
    and through the reference's ``admit_ref`` and interpret-mode kernel."""
    rng = np.random.default_rng(100 + seed)
    q = 37
    jp, tp = _planes(rng, 64, 96)
    u = rng.integers(0, N, q).astype(np.int32)
    v = rng.integers(0, N, q).astype(np.int32)
    u[::7] = N                                  # dead lanes
    u[1::5] = u[0]                              # lanes sharing a DL_out row
    fresh = np.ones(q, bool)
    kw_j, kw_t = {}, {}
    if cut in ("m", "md"):
        m_cut = rng.integers(90, 110, q).astype(np.int32)
        kw_j.update(m_cut=jnp.asarray(m_cut), m_total=jnp.int32(100))
        kw_t.update(m_cut=torch.from_numpy(m_cut), m_total=100)
        fresh &= m_cut >= 100
    if cut == "md":
        d_cut = rng.integers(0, 3, q).astype(np.int32)
        kw_j.update(d_cut=jnp.asarray(d_cut), d_total=jnp.int32(1))
        kw_t.update(d_cut=torch.from_numpy(d_cut), d_total=1)
        fresh &= d_cut >= 1
    uc, vc = np.minimum(u, N - 1), np.minimum(v, N - 1)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    planes = (tp.bl_in, tp.bl_out, tp.dl_in, tp.dl_out)
    gated = admit_plain(*planes, tu, tv, **kw_t)
    streamed = admit_streamed_plain(
        *planes, tu, tv, torch.from_numpy(fresh.astype(np.int32)))
    # the folded plane: per-lane DL_out rows (stale ones zeroed) appended
    # below the plane, each lane reading its own row, no gate
    lane_rows = tp.dl_out[torch.from_numpy(uc).long()] * torch.from_numpy(
        fresh.astype(np.int32))[:, None]
    folded = admit_plain(tp.bl_in, tp.bl_out, tp.dl_in,
                         torch.cat([tp.dl_out, lane_rows]),
                         torch.arange(N, N + q, dtype=torch.int32), tv)
    np.testing.assert_array_equal(folded.numpy(), gated.numpy())
    np.testing.assert_array_equal(folded.numpy(), streamed.numpy())
    # the reference: admit_ref with the folded rows and no cutoff, against
    # its gated admit_ref and the interpret-mode kernel
    dlo_folded = jnp.asarray(np.asarray(jp.dl_out)[uc]
                             * fresh[:, None].astype(np.uint32)).T
    ref_folded = admit_ref(jp.bl_in.T, jp.bl_out.T, jp.dl_in.T,
                           jp.bl_in[vc].T, jp.bl_out[vc].T, dlo_folded,
                           out_dtype=jnp.int8)
    cuts = {k: (jnp.reshape(a, (1, -1)) if a.ndim else a)
            for k, a in kw_j.items()}
    ref_gated = admit_ref(jp.bl_in.T, jp.bl_out.T, jp.dl_in.T,
                          jp.bl_in[vc].T, jp.bl_out[vc].T, jp.dl_out[uc].T,
                          **cuts, out_dtype=jnp.int8)
    kernel = j_admit_plane(jp, jnp.asarray(u), jnp.asarray(v), **kw_j,
                           n_block=64, q_block=32, interpret=True,
                           out_dtype=jnp.int8)
    np.testing.assert_array_equal(np.asarray(ref_folded),
                                  np.asarray(ref_gated))
    np.testing.assert_array_equal(np.asarray(ref_folded), np.asarray(kernel))
    np.testing.assert_array_equal(folded.numpy(), np.asarray(kernel))


# ----------------------------------------------------- launch geometry
SIZES = (1, 3, 37, 64, 513, 60_000)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_admit_geometry_covers_every_byte_once(n, streamed):
    """The (block, thread, lane group, row) mapping both kernels use writes
    every byte of the (n, Q) plane exactly once, for ragged n and Q, word
    widths that take every lane count and the run-time-width tile, and a
    chunk that divides no n; the shared memory fits the card and chunks
    stay multiples of 4."""
    for q in SIZES:
        for wb, wd in ((2, 2), (4, 4), (5, 1)):
            for nb in ((None, 36) if streamed else (None,)):
                g = admit_geometry(n, q, wb, wd, 132, streamed=streamed,
                                   n_block=nb)
                what = (n, q, wb, wd, g)
                assert g.smem <= _build.MAX_SMEM_BYTES, what
                assert g.n_block % 4 == 0 and (g.n_block > 0) == streamed
                assert g.lanes in (4, 8) and g.span * g.rows <= g.threads
                # lane groups tile [0, Q), and packed stores only where
                # every group is whole
                assert (g.groups - 1) * g.lanes < q <= g.groups * g.lanes
                assert not g.pack or q % g.lanes == 0
                assert g.slabs * g.span >= g.groups
                if n * g.groups <= 2 * 10**7:
                    cover = admit_coverage(g, n)
                    assert cover.shape == (n, g.groups)
                    assert (cover == 1).all(), what


def test_admit_geometry_defaults():
    g = admit_geometry(60_000, 64, 2, 2, 132)
    assert (g.lanes, g.groups, g.rows, g.blocks, g.pack) == \
        (8, 8, 32, 264, True)
    s = admit_geometry(60_000, 64, 2, 2, 132, streamed=True)
    assert (s.lanes, s.rows, s.n_block, s.blocks, s.smem) == \
        (4, 32, 456, 132, 6 * 64 * 4 + 2 * 456 * 6 * 4)
    # ragged and Q % 8 == 4: four lanes a thread, bytes or 32-bit words
    assert admit_geometry(60_000, 37, 2, 2, 132).pack is False
    assert admit_geometry(60_000, 36, 2, 2, 132).lanes == 4
    # wide label rows keep four lanes in registers
    assert admit_geometry(60_000, 64, 4, 4, 132).lanes == 4
    # unaligned planes: scalar loads
    u = admit_geometry(1000, 64, 2, 2, 132, streamed=True, aligned=False)
    assert not u.vec and u.n_block == 8


@pytest.mark.parametrize("streamed", [False, True])
def test_lanes_per_thread_takes_only_compiled_instances(streamed):
    """The sources compile 8 lanes a thread only for the grid kernel's
    compile-time widths with 2·Wb + Wd <= 6 (``launch_fixed`` in
    ``csrc/admit_tile.cuh``); every other pair, the run-time widths among
    them, takes 4."""
    for wb in range(1, 7):
        for wd in range(1, 7):
            for q in (1, 8, 36, 37, 64, 513):
                lanes = lanes_per_thread(q, wb, wd, streamed)
                eight = not streamed and q % 8 == 0 and 2 * wb + wd <= 6
                assert lanes == (8 if eight else 4), (wb, wd, q)
                if lanes == 8:
                    assert wb <= 4 and wd <= 4


# ---------------------------------------------------------- the build
def test_library_path_tracks_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first          # nothing changed
    (tmp_path / "tile.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.name == "libk.so"
    (tmp_path / "tile.cuh").write_text("// v1\n")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.library_path("k") != first
