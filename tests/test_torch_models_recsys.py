"""The port's MIND (``repro_torch.models.recsys.mind``) held against the
JAX package on seeded inputs: twins of ``tests/test_models_recsys.py``'s
three tests on the port, and differentials of the interests, the loss,
every gradient, ``serve`` and ``retrieval_scores`` at SMOKE.

The reference's ``init_params`` tree is carried in by
``load_numpy_params`` and the gradients back out by ``grads_to_numpy``.
Everything is float32 and sums in another order than XLA does;
tolerances as for the GNN family: values rtol 1e-5, atol 1e-5, gradients
rtol 1e-4, atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mind as jcfg_mind
from repro.models.recsys import mind as JM
from repro_torch.configs import mind as tcfg_mind
from repro_torch.models.params import (flatten_tree, grads_to_numpy,
                                       load_numpy_params, sgd_step)
from repro_torch.models.recsys.mind import MIND, _squash, \
    label_aware_attention

JCFG = jcfg_mind.SMOKE
CFG = tcfg_mind.SMOKE
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def make_batch(rng, b=8):
    """The reference test's batch as numpy: ids in range, ~80 % of the
    history live, the first slot always."""
    mask = (rng.random((b, CFG.hist_len)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return {
        "hist": rng.integers(0, CFG.n_items, (b, CFG.hist_len))
        .astype(np.int32),
        "hist_mask": mask,
        "target": rng.integers(0, CFG.n_items, b).astype(np.int32),
        "negatives": rng.integers(0, CFG.n_items, CFG.n_neg).astype(np.int32),
    }


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def carried(key):
    """(reference params, the port's module holding the same values)."""
    params = JM.init_params(jax.random.PRNGKey(key), JCFG)
    module = MIND(CFG, device="cpu")
    load_numpy_params(module, jax.tree.map(np.asarray, params))
    return params, module


def test_config_equals_reference():
    assert CFG == type(CFG)(**vars(JCFG))
    assert tcfg_mind.CONFIG.n_items == jcfg_mind.CONFIG.n_items == 2 ** 21


# ------------------------------------------------- twins of the JAX tests
def test_interests_shape_and_finite():
    rng = np.random.default_rng(0)
    b = to_torch(make_batch(rng))
    u = MIND(CFG, seed=0, device="cpu").interests(b["hist"], b["hist_mask"])
    assert u.shape == (8, CFG.n_interests, CFG.embed_dim)
    assert torch.isfinite(u).all()


def test_train_step_decreases_loss():
    rng = np.random.default_rng(1)
    batch = to_torch(make_batch(rng))
    model = MIND(CFG, seed=1, device="cpu")
    losses = []
    for _ in range(6):
        loss, _ = model.loss_fn(batch)
        loss.backward()
        sgd_step(model, 0.5)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_retrieval_is_max_over_interests():
    rng = np.random.default_rng(2)
    model = MIND(CFG, seed=2, device="cpu")
    b = to_torch(make_batch(rng, b=2))
    cands = torch.as_tensor(rng.integers(0, CFG.n_items, 100)
                            .astype(np.int32))
    with torch.no_grad():
        scores = model.retrieval_scores(b["hist"], b["hist_mask"], cands)
        u = model.interests(b["hist"], b["hist_mask"]).numpy()
        ce = model.item_embed.numpy()[cands.numpy()]
    assert scores.shape == (2, 100)
    want = np.einsum("bkd,cd->bkc", u, ce).max(1)
    np.testing.assert_allclose(scores.numpy(), want, **FWD)


# --------------------------------------------------- against the reference
def test_init_scales_and_names_equal_reference():
    """The port's own init has the reference's tree, shapes, dtypes and
    scales (std within 5 % at 64 000 draws)."""
    want = flatten_tree(jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(0), JCFG)))
    got = dict(MIND(CFG, seed=0, device="cpu").named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g.std(), w.std(), rtol=0.05, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("key", [0, 3])
def test_model_equals_reference(key):
    """Interests (``serve``), the loss, every gradient and the retrieval
    scores from the reference's parameters."""
    rng = np.random.default_rng(10 + key)
    params, model = carried(key)
    batch = make_batch(rng)
    jb, tb = to_jax(batch), to_torch(batch)

    want_u = JM.serve(params, JCFG, jb["hist"], jb["hist_mask"])
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: JM.loss_fn(p, JCFG, jb), has_aux=True)(params)
    cands = rng.integers(0, CFG.n_items, 300).astype(np.int32)
    want_s = JM.retrieval_scores(params, JCFG, jb["hist"], jb["hist_mask"],
                                 jnp.asarray(cands))

    with torch.no_grad():
        got_u = model.serve(tb["hist"], tb["hist_mask"])
        got_s = model.retrieval_scores(tb["hist"], tb["hist_mask"],
                                       torch.as_tensor(cands))
    got_loss, got_m = model.loss_fn(tb)
    got_loss.backward()
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **FWD)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **FWD)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               **FWD)
    np.testing.assert_allclose(float(got_m["loss"].detach()),
                               float(want_m["loss"]), **FWD)
    want_g = flatten_tree(jax.tree.map(np.asarray, want_g))
    got_g = grads_to_numpy(model)
    assert set(got_g) == set(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], err_msg=name,
                                   **GRAD)


def test_squash_and_label_aware_attention_equal_reference():
    """The two building blocks on random capsules, with a zero capsule
    (squash's eps) and scores of both signs (the pow-sharpening's
    sign)."""
    rng = np.random.default_rng(5)
    z = rng.normal(size=(3, 4, 16)).astype(np.float32)
    z[0, 1] = 0.0
    tgt = rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(_squash(torch.as_tensor(z)).numpy(),
                               np.asarray(JM._squash(jnp.asarray(z))), **FWD)
    for p in (1.0, 2.0, 3.5):
        np.testing.assert_allclose(
            label_aware_attention(torch.as_tensor(z), torch.as_tensor(tgt),
                                  p).numpy(),
            np.asarray(JM.label_aware_attention(jnp.asarray(z),
                                                jnp.asarray(tgt), p)),
            **FWD)


def test_negative_ids_wrap_as_the_reference():
    """An id in [-n_items, 0) wraps once on both sides (``jnp.take`` and
    torch indexing); ids outside [-n, n) are left out by design (the
    reference fills NaN, torch raises)."""
    rng = np.random.default_rng(6)
    params, model = carried(0)
    batch = make_batch(rng, b=2)
    batch["hist"][:, 1] -= CFG.n_items
    jb, tb = to_jax(batch), to_torch(batch)
    with torch.no_grad():
        got = model.interests(tb["hist"], tb["hist_mask"]).numpy()
    want = JM.interests(params, JCFG, jb["hist"], jb["hist_mask"])
    np.testing.assert_allclose(got, np.asarray(want), **FWD)
    bad = tb["hist"].clone()
    bad[0, 0] = CFG.n_items
    with pytest.raises(IndexError):
        model.interests(bad, tb["hist_mask"])
