"""The verdict kernel's plain version (the CPU path of the port's
``dbl_query_verdicts``) against the JAX Pallas kernel in interpret mode and
its reference, bitwise; the verdict kernels' launch geometry, compiled
instances and build hash."""
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as JB
from repro.core import query as JQ
from repro.kernels.dbl_query.ops import verdicts_device as j_verdicts_device
from repro.kernels.dbl_query.ref import verdict_ref
from repro_torch.core import bitset as TB
from repro_torch.core import query as TQ
from repro_torch.kernels import _build
from repro_torch.kernels.dbl_query import ops as T_ops
from repro_torch.kernels.dbl_query.dbl_query import (
    dbl_query_verdicts, verdict_coverage, verdict_geometry, verdicts_plain)

N = 97


def _planes(rng, k, kp):
    dens = rng.uniform(0.05, 0.3)
    bits = [rng.random((N, kk)) < dens for kk in (k, k, kp, kp)]
    # make some BL rows empty so containment holds on some pairs
    for b in bits[2:]:
        b[rng.random(N) < 0.3] = False
    jp = JQ.PackedLabels(*(JB.pack(jnp.asarray(b)) for b in bits))
    tp = TQ.PackedLabels(*(TB.pack(torch.from_numpy(b)) for b in bits))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy())
    return jp, tp


CASES = [
    # q, k, k', cut ("none" | "m" | "md"), il, out dtype
    (1, 32, 64, "none", False, "int32"),
    (37, 40, 96, "none", False, "int8"),
    (513, 64, 64, "none", False, "int32"),
    (37, 32, 64, "m", False, "int32"),
    (513, 40, 96, "md", False, "int8"),
    (37, 64, 64, "md", False, "int32"),
    (37, 40, 96, "none", True, "int32"),
    (513, 64, 64, "md", True, "int8"),
    (1, 40, 96, "md", True, "int8"),
    (513, 32, 64, "m", False, "int8"),
]


@pytest.mark.parametrize("q,k,kp,cut,with_il,out", CASES)
def test_plain_verdicts_match_pallas_and_ref(q, k, kp, cut, with_il, out):
    rng = np.random.default_rng(q * 7 + k + kp)
    jp, tp = _planes(rng, k, kp)
    u = rng.integers(0, N, q).astype(np.int32)
    v = rng.integers(0, N, q).astype(np.int32)
    v[::5] = u[::5]                                   # self-queries
    kw_j, kw_t = {}, {}
    if cut in ("m", "md"):
        m_total = 500
        m_cut = rng.integers(450, 550, q).astype(np.int32)
        kw_j.update(m_cut=jnp.asarray(m_cut), m_total=jnp.int32(m_total))
        kw_t.update(m_cut=torch.from_numpy(m_cut), m_total=m_total)
    if cut == "md":
        d_cut = rng.integers(2, 5, q).astype(np.int32)
        kw_j.update(d_cut=jnp.asarray(d_cut), d_total=jnp.int32(3))
        kw_t.update(d_cut=torch.from_numpy(d_cut), d_total=3)
    il_j = il_t = None
    if with_il:
        il = [rng.integers(-50, 50, (N, 6)).astype(np.int32)
              for _ in range(2)]
        il_j = tuple(jnp.asarray(x) for x in il)
        il_t = tuple(torch.from_numpy(x) for x in il)
    jdt = jnp.int8 if out == "int8" else jnp.int32
    tdt = torch.int8 if out == "int8" else torch.int32
    want = np.asarray(j_verdicts_device(
        jp, jnp.asarray(u), jnp.asarray(v), il=il_j, q_block=128,
        interpret=True, out_dtype=jdt, **kw_j))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    got = verdicts_plain(*tp, tu, tv, **kw_t,
                         il_in=None if il_t is None else il_t[0],
                         il_out=None if il_t is None else il_t[1],
                         out_dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        T_ops.verdicts_device(tp, tu, tv, il=il_t, out_dtype=tdt,
                              **kw_t).numpy(), want)
    if not with_il:
        streams = [np.asarray(s).T for s in JQ.gather_rows(
            jp, jnp.asarray(u), jnp.asarray(v))]
        dlo_u, dli_v, dlo_v, dli_u, blin_u, blin_v, blout_v, blout_u = \
            [jnp.asarray(s) for s in streams]
        ref = verdict_ref(dlo_u, dli_v, dlo_v, dli_u, blin_u, blin_v,
                          blout_u, blout_v, jnp.asarray(u == v),
                          out_dtype=jdt, **kw_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if cut == "none":
        # the core torch algebra the plain version builds on, against the
        # reference's core
        core = TQ.label_verdicts(tp, tu, tv, il=il_t)
        want_core = JQ.label_verdicts(jp, jnp.asarray(u), jnp.asarray(v),
                                      il=il_j)
        np.testing.assert_array_equal(core.numpy(), np.asarray(want_core))


def test_query_verdicts_clamps_dead_lane_and_matches_core():
    rng = np.random.default_rng(5)
    jp, tp = _planes(rng, 64, 64)
    u = np.array([0, N, N - 1, 5], np.int32)          # N is a dead lane
    v = np.array([3, 1, N, 5], np.int32)
    got = T_ops.query_verdicts(tp, u, v, device="cpu")
    want = JQ.label_verdicts(jp, jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int32))
    with pytest.raises(ValueError):
        dbl_query_verdicts(*tp, torch.from_numpy(u), torch.from_numpy(v),
                           d_cut=torch.zeros(4, dtype=torch.int32),
                           d_total=1)


# ------------------------------------------------------ launch geometry
def test_verdict_geometry_grid_covers_every_lane_once():
    """The grid kernel's blocks write each lane exactly once, for ragged
    and wide Q, and the LJ label batch puts work on every SM."""
    for q in (1, 31, 37, 64, 513, 20_032, 200_003):
        for wd, wb in ((2, 2), (4, 4), (5, 2), (1, 3)):
            g = verdict_geometry(q, wd, wb, 132, streamed=False,
                                 aligned=True)
            assert g.threads % 32 == 0 and g.threads <= 256
            cover = verdict_coverage(g, q)
            assert (cover.sum(0) == 1).all(), (q, g)
    assert verdict_geometry(20_032, 2, 2, 132, False, True).blocks >= 132


def test_verdict_geometry_takes_only_compiled_instances():
    """Compile-time widths for W in 1..4, vector row loads only where the
    planes are aligned and a width is 2 or 4, the run-time widths beyond;
    the sources compile exactly those 16 + 12 pairs
    (``verdict::dispatch`` in ``csrc/verdict_tile.cuh``)."""
    seen = set()
    for wd in range(0, 7):
        for wb in range(0, 7):
            for aligned in (False, True):
                inst = verdict_geometry(37, wd, wb, 132, streamed=False,
                                        aligned=aligned).instance
                assert verdict_geometry(
                    37, wd, wb, 132, streamed=True,
                    aligned=aligned).instance == inst
                if not (1 <= wd <= 4 and 1 <= wb <= 4):
                    assert inst is None
                    continue
                assert inst[:2] == (wd, wb)
                assert inst[2] == (aligned and bool({wd, wb} & {2, 4}))
                seen.add(inst)
    assert len(seen) == 28 and sum(i[2] for i in seen) == 12
    tile = (_build.CSRC / "verdict_tile.cuh").read_text()
    cases = set(re.findall(r"VERDICT_CASE\((\d), (\d)\)", tile))
    assert cases == {(str(d), str(b)) for d in range(1, 5)
                     for b in range(1, 5)}
    assert "if constexpr (D == 2 || D == 4 || B == 2 || B == 4)" in tile


def test_library_path_tracks_verdict_tile(tmp_path, monkeypatch):
    """Both verdict sources include the shared tile, and an edit to it
    rebuilds both libraries."""
    for name in ("dbl_query", "dbl_query_streamed"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "verdict_tile.cuh"' in src
    shutil.copytree(_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    before = {n: _build.library_path(n)
              for n in ("dbl_query", "dbl_query_streamed")}
    tile = tmp_path / "csrc" / "verdict_tile.cuh"
    tile.write_text(tile.read_text() + "// edited\n")
    for n, path in before.items():
        assert _build.library_path(n) != path
