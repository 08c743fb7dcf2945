"""The port's gradient codecs (``repro_torch.train.compress``) held
against the JAX package's, and the twin of
``tests/test_train_substrate.py::test_compression_codecs``.

The codecs and the loop's transform are elementwise casts, a max and
half-to-even rounding, so they are held bitwise.  ``compressed_psum``
runs over 4 gloo ranks.  The file is also the script that runs them:
pytest starts ``python tests/test_torch_train_compress.py <out_dir>`` in
a subprocess under a time limit; the script spawns 4 processes
(``torch.multiprocessing``, one gloo rank each over a ``FileStore``, a
120 s group timeout), rank r reduces row r of each codec's (4, ...) input
and writes what it got to ``<out_dir>/rank<r>.npz``.  The reference is
``compressed_psum`` under ``jax.vmap(axis_name=)`` over the same rows.
int8 is held bitwise (every rank's int32 sum is exact).  bf16 and none
add in another order than XLA's: gloo adds the bf16 terms rounding each
partial sum to bf16, so each side is within 1.5 bf16 ulps (half an ulp a
rounded add, three adds) of the exact sum of the rounded terms, and the
two within 2**-6 * sum_r |g_r|; float32 within 2**-21 * sum_r |g_r|.
"""
import os
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.train import compress as JC
from repro_torch.models.params import tree_leaves
from repro_torch.train import compress as TC

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
GROUP_TIMEOUT_S = 120
RUN_TIMEOUT_S = 300
CODECS = ("bf16", "int8", "none")
#: |got - want| <= tol * sum_r |g_r|, elementwise
PSUM_TOL = {"bf16": 2.0 ** -6, "int8": 0.0, "none": 2.0 ** -21}


def _x(seed, shape=(64, 32)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ties(seed):
    """Magnitudes on a coarse grid, so the k-th largest has ties."""
    return (np.round(_x(seed, (40, 25)) * 4) / 4).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _same(got, want):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _tree_same(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)


# ------------------------------------------------------------ the codecs
def test_bf16_round_trip_bitwise():
    tree = {"a": _x(0), "b": {"c": _x(1, (7,))}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {"a": torch.tensor(tree["a"]), "b": {"c": torch.tensor(
        tree["b"]["c"])}}
    _tree_same(TC.bf16_compress(tt), JC.bf16_compress(jt))
    _tree_same(TC.bf16_decompress(TC.bf16_compress(tt)),
               JC.bf16_decompress(JC.bf16_compress(jt)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codec_bitwise(seed):
    x = _x(seed) * (10.0 ** (seed - 1))
    if seed == 2:   # exact halves: round half to even on both sides
        x = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                     np.float32) / 16
    q, s = TC.int8_encode(torch.tensor(x))
    jq, js = JC.int8_encode(jnp.asarray(x))
    _same(q, jq)
    _same(s, js)
    _same(TC.int8_decode(q, s), JC.int8_decode(jq, js))


@pytest.mark.parametrize("frac", [0.1, 0.37, 1e-4])
@pytest.mark.parametrize("make", [_x, _ties], ids=["normal", "ties"])
def test_topk_sparsify_bitwise(frac, make):
    x = make(5)
    kept, res = TC.topk_sparsify(torch.tensor(x), frac)
    jk, jr = JC.topk_sparsify(jnp.asarray(x), frac)
    _same(kept, jk)
    _same(res, jr)


def test_topk_error_feedback_bitwise():
    g = {"w": _ties(6), "b": _x(7, (33,))}
    jg = jax.tree.map(jnp.asarray, g)
    tg = {k: torch.tensor(v) for k, v in g.items()}
    jr = jax.tree.map(jnp.zeros_like, jg)
    tr = {k: torch.zeros_like(v) for k, v in tg.items()}
    for _ in range(3):
        jk, jr = JC.topk_with_error_feedback(jg, jr, 0.05)
        tk, tr = TC.topk_with_error_feedback(tg, tr, 0.05)
        _tree_same(tk, jk)
        _tree_same(tr, jr)


@pytest.mark.parametrize("codec", [None, "none", "bf16", "int8"])
def test_grad_transform_bitwise(codec):
    g = {"w": _x(8), "n": {"b": _x(9, (5,)), "h": _x(10, (2, 3, 4))}}
    jg = jax.tree.map(jnp.asarray, g)
    tg = {"w": torch.tensor(g["w"]),
          "n": {k: torch.tensor(v) for k, v in g["n"].items()}}
    _tree_same(TC.make_grad_transform(codec)(tg),
               JC.make_grad_transform(codec)(jg))
    with pytest.raises(ValueError):
        TC.make_grad_transform("fp4")


def test_compression_codecs():
    """The twin of the reference test, on the port alone."""
    x = torch.tensor(_x(0))
    q, s = TC.int8_encode(x)
    back = TC.int8_decode(q, s)
    assert float((back - x).abs().max()) <= float(s) * 0.51 + 1e-6
    kept, res = TC.topk_sparsify(x, 0.1)
    nz = int((kept != 0).sum())
    assert abs(nz - int(x.numel() * 0.1)) <= 1
    np.testing.assert_allclose((kept + res).numpy(), x.numpy(), rtol=1e-6)
    grads = {"w": x}
    residual = {"w": torch.zeros_like(x)}
    g1, r1 = TC.topk_with_error_feedback(grads, residual, 0.1)
    g2, r2 = TC.topk_with_error_feedback(grads, r1, 0.1)
    total = (g1["w"] + g2["w"] + r2["w"]).numpy()
    np.testing.assert_allclose(total, 2 * x.numpy(), rtol=1e-5)


# ------------------------------------------------------ compressed_psum
def _inputs():
    """Each codec's (WORLD, ...) input: rank r reduces row r."""
    return {"bf16": _x(11, (WORLD, 48, 16)),
            "int8": _x(12, (WORLD, 48, 16)) * np.array(
                [1, 3, 0.5, 2], np.float32)[:, None, None],
            "none": _x(13, (WORLD, 300))}


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = {codec: TC.compressed_psum(torch.tensor(x[rank]),
                                         codec=codec).numpy()
               for codec, x in _inputs().items()}
        with pytest.raises(ValueError):
            TC.compressed_psum(torch.zeros(3), codec="fp4")
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_compressed_psum_over_gloo_equals_reference():
    out_dir = tempfile.mkdtemp(prefix="psum_world_")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, out_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    want = {codec: np.asarray(jax.vmap(
        lambda g, c=codec: JC.compressed_psum(g, "r", c),
        axis_name="r")(jnp.asarray(x))) for codec, x in _inputs().items()}
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the gloo ranks ran past {RUN_TIMEOUT_S} s:"
                             f"\n{err}")
    assert proc.returncode == 0, out + "\n" + err
    inputs = _inputs()
    for rank in range(WORLD):
        got = np.load(os.path.join(out_dir, f"rank{rank}.npz"))
        for codec in CODECS:
            g, w = got[codec], want[codec][rank]
            assert g.dtype == np.float32 and g.shape == w.shape
            bound = PSUM_TOL[codec] * np.abs(inputs[codec]).sum(axis=0)
            err = np.abs(g - w)
            assert (err <= bound).all(), (rank, codec, float(err.max()))
            if codec == "int8":
                np.testing.assert_array_equal(g, w)


if __name__ == "__main__":
    torch.multiprocessing.spawn(
        _rank_main, nprocs=WORLD, join=True,
        args=(WORLD, os.path.join(sys.argv[1], "store"), sys.argv[1]))
