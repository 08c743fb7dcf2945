"""The admit-plane kernel's plain version (the CPU path of the port's
``bfs_admit_plane``) against the JAX Pallas kernel in interpret mode and
its reference, bitwise."""
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
from repro_torch.kernels.bfs_prune.bfs_prune import admit_plain
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
