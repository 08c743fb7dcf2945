"""The port's optimizers (``repro_torch.train.optim``) held against the
JAX package's, and twins of ``tests/test_train_substrate.py``'s optimizer
tests.

Both sides take the same parameters and gradients (numpy, from a seed)
through three successive updates; float32 and bfloat16 leaves of ndim 1,
2 and 3 (Adafactor factors the last two), with and without weight decay.

Tolerances.  The arithmetic is the same float32 sequence on both sides,
but ``pow`` (the bias corrections), ``rsqrt`` and the means' summation
order may round differently from XLA's by a float32 ulp: float32 values
within rtol 1e-6, atol 1e-7.  A bfloat16 parameter is the float32 result
rounded once, so such an ulp can move it across a rounding boundary:
within one bfloat16 ulp of the reference's value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as JO
from repro_torch.models.params import tree_leaves
from repro_torch.train import optim as TO

F32 = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"bias": (24,), "w": (16, 24), "stack": (3, 8, 12)}
STEPS = 3


def _tree(rng):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()} | {"nested": {"w": rng.normal(
                size=(8, 5)).astype(np.float32)}}


def _jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _torch(tree, dtype):
    return {k: (_torch(v, dtype) if isinstance(v, dict)
                else torch.tensor(v).to(dtype)) for k, v in tree.items()}


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _bf16_ulp(x):
    """One bfloat16 ulp at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _close(got, want, msg):
    if want.dtype == jnp.bfloat16:
        w = _f64(want)
        assert (np.abs(_f64(got) - w) <= _bf16_ulp(w)).all(), msg
    else:
        np.testing.assert_allclose(_f64(got), _f64(want), err_msg=msg,
                                   **F32)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_update_equals_reference(name, dtype, wd):
    rng = np.random.default_rng(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p0 = _tree(rng)
    jinit, jupd = JO.OPTIMIZERS[name]
    tinit, tupd = TO.OPTIMIZERS[name]
    jp, tp = _jax(p0, jdt), _torch(p0, tdt)
    js, ts = jinit(jp), tinit(tp)
    for step in range(STEPS):
        g = _tree(rng)
        lr = 1e-2 * (step + 1)
        jp, js = jupd(_jax(g, jdt), js, jp, lr=lr, weight_decay=wd)
        tp, ts = tupd(_torch(g, tdt), ts, tp, lr=lr, weight_decay=wd)
        want = jax.tree.leaves((jp, js))
        got = tree_leaves((tp, ts))
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"step {step} leaf {i}")
        assert isinstance(ts.step, np.int32) and ts.step == step + 1


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_inplace_update_equals_functional(name):
    """``inplace=True`` (the step's donate) writes the same values into
    the given tensors and returns them."""
    rng = np.random.default_rng(4)
    init, upd = TO.OPTIMIZERS[name]
    p = _torch(_tree(rng), torch.float32)
    g = _torch(_tree(rng), torch.float32)
    s = init(p)
    want_p, want_s = upd(g, s, p, lr=0.05)
    got_p, got_s = upd(g, s, p, lr=0.05, inplace=True)
    for a, b, orig in zip(tree_leaves((got_p, got_s[:2])),
                          tree_leaves((want_p, want_s[:2])),
                          tree_leaves((p, s[:2]))):
        assert a is orig and torch.equal(a, b)


@pytest.mark.parametrize("args", [(1e-3, 10, 100), (3e-4, 20, 400),
                                  (1e-2, 0, 30)])
def test_cosine_schedule_equals_reference(args):
    want = JO.cosine_schedule(*args)
    got = TO.cosine_schedule(*args)
    for step in range(args[2] + 6):
        w = float(want(jnp.int32(step)))
        g = got(np.int32(step))
        assert isinstance(g, np.float32)
        np.testing.assert_allclose(float(g), w, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")


# ------------------------------------------------- twins of the JAX tests
def quad_loss(params, batch):
    err = params["w"] - batch["target"]
    return torch.sum(err * err)


def test_adamw_and_adafactor_converge():
    for init, update in [(TO.adamw_init, TO.adamw_update),
                         (TO.adafactor_init, TO.adafactor_update)]:
        params = {"w": torch.ones((4, 8)) * 3.0}
        state = init(params)
        tgt = {"target": torch.zeros((4, 8))}
        for _ in range(200):
            w = params["w"].detach().requires_grad_()
            (g,) = torch.autograd.grad(quad_loss({"w": w}, tgt), [w])
            params, state = update({"w": g}, state, params, lr=5e-2)
        assert float(params["w"].abs().max()) < 0.3


def test_cosine_schedule_shape():
    lr = TO.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < 1e-5
