"""The port's transformer family (``repro_torch.models.transformer``) and
``serve/decode.py`` held against the JAX package on all five SMOKE
configs, and the twin of ``examples/serve_lm.py``.

Twins of ``tests/test_models_lm.py``'s four tests run on the port alone.
The differentials carry the reference's ``init_params`` tree in with
``load_numpy_params`` and compare: ``forward``'s logits and aux,
``forward_hidden``, ``loss_fn`` with every gradient (also with
``ce_chunk``), ``prefill``'s logits and cache, three ``decode_step``s'
logits and caches, and ``generate``'s greedy and sampled ids (equal).
The reference's outputs are computed once a config (``reference``).

Tolerances.  Float32 compute (the SMOKE configs): values rtol 1e-5, atol
1e-5, float32-stored gradients rtol 1e-4, atol 1e-5, as for the GNN
family.  gemma2's, moonshot's and arctic's SMOKE configs store their
weights in bfloat16 (``param_dtype``), so those gradients are bfloat16 on
both sides: each use's float32 gradient is rounded to bfloat16 and the
uses' are added there, in another order than XLA's.  Held within two
bfloat16 ulps of the value plus half an ulp of the leaf's largest
(``close_grads``): a tied embedding row sums an input and an output
contribution that nearly cancel, measured 2.4e-4 off where the leaf's
largest is 0.57.  bfloat16 compute (``test_bf16_equals_reference``): the
tolerance ``BF16_FWD`` that the measured gap needs."""
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import attention as JA
from repro.models.transformer import model as JMod
from repro.models.transformer import moe as JMoE
from repro.models.transformer import rope as JRope
from repro.serve import decode as JDec
from repro_torch.core import _threefry
from repro_torch.models.params import (flatten_tree, grads_to_numpy,
                                       load_numpy_params, sgd_step)
from repro_torch.models.transformer import attention as TA
from repro_torch.models.transformer import moe as TMoE
from repro_torch.models.transformer import rope as TRope
from repro_torch.models.transformer.model import Transformer
from repro_torch.serve import decode as TDec

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"gemma2-27b": "gemma2_27b", "qwen1.5-0.5b": "qwen15_05b",
         "tinyllama-1.1b": "tinyllama_11b",
         "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
         "arctic-480b": "arctic_480b"}
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
#: bfloat16 compute against XLA's bfloat16, as |got - want| <= rtol |want|
#: + atol max|want|: the measured gap is at most 1.7e-2 of the largest
#: logit (gemma2; 2.5 bf16 ulps at tinyllama's largest)
BF16_FWD = dict(rtol=1e-2, atol=2e-2)
B, S, STEPS = 2, 12, 3


def configs(name):
    mod = ARCHS[name]
    return (importlib.import_module(f"repro.configs.{mod}").SMOKE,
            importlib.import_module(f"repro_torch.configs.{mod}").SMOKE)


def tokens(seed, shape, vocab):
    """int32 token ids from a numpy seed."""
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def carried(jcfg, tcfg, key=0):
    """(reference params, the port's model holding the same values)."""
    params = JMod.init_params(jax.random.PRNGKey(key), jcfg)
    model = Transformer(tcfg, device="cpu")
    load_numpy_params(model, jax.tree.map(np.asarray, params))
    return params, model


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(f32(got), f32(want), err_msg=msg, **tol)


def close_scaled(got, want, tol, msg=""):
    """|got - want| <= rtol |want| + atol max|want|."""
    got, want = f32(got), f32(want)
    err = np.abs(got - want)
    bound = tol["rtol"] * np.abs(want) + tol["atol"] * np.abs(want).max()
    assert (err <= bound).all(), (msg, float(err.max()),
                                  float(np.abs(want).max()))


def close_grads(got, want, params):
    """Every gradient leaf, each at its storage type's tolerance."""
    want = flatten_tree(jax.tree.map(f32, want))
    dtypes = {k: v.dtype for k, v in flatten_tree(params).items()}
    assert set(got) == set(want)
    for name in want:
        if dtypes[name] == jnp.bfloat16:
            w = want[name]
            err = np.abs(got[name] - w)
            bound = 2.0 ** -6 * np.abs(w) + 2.0 ** -9 * np.abs(w).max()
            assert (err <= bound).all(), (name, float(err.max()))
        else:
            close(got[name], want[name], GRAD, name)


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's outputs on this config, computed once: params,
    forward, hidden, loss and gradients, prefill and three decode steps,
    greedy and sampled ``generate``."""
    jcfg, _ = configs(name)
    params = JMod.init_params(jax.random.PRNGKey(0), jcfg)
    tok = tokens(1, (B, 16), jcfg.vocab)
    tgt = np.roll(tok, -1, axis=1)
    out = {"params": params, "tok": tok, "tgt": tgt}
    out["logits"], out["aux"] = JMod.forward(params, jcfg, jnp.asarray(tok))
    out["hidden"], out["hidden_aux"] = JMod.forward_hidden(
        params, jcfg, jnp.asarray(tok))
    (out["loss"], out["metrics"]), out["grads"] = jax.jit(
        jax.value_and_grad(lambda p: JMod.loss_fn(
            p, jcfg, jnp.asarray(tok), jnp.asarray(tgt)), has_aux=True))(
        params)
    seq = tokens(2, (B, S + STEPS), jcfg.vocab)
    out["seq"] = seq
    out["prefill"] = JMod.prefill(params, jcfg, jnp.asarray(seq[:, :S]),
                                  S + STEPS + 1)
    cache, steps = out["prefill"][1], []
    for i in range(STEPS):
        logits, cache = JDec.serve_step(params, jcfg, cache,
                                        jnp.asarray(seq[:, S + i]),
                                        jnp.int32(S + i))
        steps.append((logits, cache))
    out["steps"] = steps
    out["greedy"] = JDec.generate(params, jcfg, jnp.asarray(seq[:, :S]), 6)
    out["sampled"] = JDec.generate(params, jcfg, jnp.asarray(seq[:, :S]), 6,
                                   greedy=False, rng=jax.random.PRNGKey(5))
    return out


@functools.lru_cache(maxsize=None)
def port_model(name):
    ref = reference(name)
    _, tcfg = configs(name)
    model = Transformer(tcfg, device="cpu")
    return load_numpy_params(model, jax.tree.map(np.asarray, ref["params"]))


# ------------------------------------------------- twins of the JAX tests
@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_shapes_and_finite(name):
    _, cfg = configs(name)
    model = Transformer(cfg, seed=0, device="cpu")
    tok = torch.as_tensor(tokens(1, (2, 16), cfg.vocab))
    with torch.no_grad():
        logits, aux = model(tok)
    assert logits.shape == (2, 16, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    assert torch.isfinite(aux)


@pytest.mark.parametrize("name", list(ARCHS))
def test_train_step_decreases_loss(name):
    _, cfg = configs(name)
    model = Transformer(cfg, seed=0, device="cpu")
    tok = torch.as_tensor(tokens(1, (2, 16), cfg.vocab))
    tgt = torch.roll(tok, -1, dims=1)
    losses = []
    for _ in range(4):
        loss, _ = model.loss_fn(tok, tgt)
        loss.backward()
        sgd_step(model, 0.5)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_decode_matches_forward(name):
    """prefill(S) + decode_step equals the full forward at position S."""
    _, cfg = configs(name)
    model = Transformer(cfg, seed=0, device="cpu")
    tok = torch.as_tensor(tokens(2, (2, S + 1), cfg.vocab))
    with torch.no_grad():
        full, _ = model(tok)
        last, cache = model.prefill(tok[:, :S], s_cache=S + 4)
        dec, _ = model.decode_step(cache, tok[:, S], S)
    close(last, full[:, S - 1], dict(rtol=2e-4, atol=2e-4))
    close(dec, full[:, S], dict(rtol=2e-3, atol=2e-3))


def test_local_window_masks_differ_from_global():
    """gemma2's local layers mask: widening the window changes the
    output on a sequence longer than it."""
    _, cfg = configs("gemma2-27b")
    model = Transformer(cfg, seed=0, device="cpu")
    tok = torch.as_tensor(tokens(3, (1, 32), cfg.vocab))
    with torch.no_grad():
        a, _ = model(tok)
        model.cfg = cfg.scaled(window=32)
        b, _ = model(tok)
    assert not np.allclose(f32(a), f32(b))


# --------------------------------------------------- against the reference
@pytest.mark.parametrize("name", list(ARCHS))
def test_init_equals_reference_tree(name):
    """The port's own init has the reference's tree, shapes, dtypes and
    scales (std within 10 %, zeros where the reference's are)."""
    jcfg, tcfg = configs(name)
    want = flatten_tree(jax.tree.map(
        f32, JMod.init_params(jax.random.PRNGKey(0), jcfg)))
    dtypes = flatten_tree(jax.tree.map(
        lambda x: x.dtype, JMod.init_params(jax.random.PRNGKey(0), jcfg)))
    got = dict(Transformer(tcfg, seed=0, device="cpu").named_parameters())
    assert set(got) == set(want)
    for name_, w in want.items():
        g = got[name_]
        assert tuple(g.shape) == w.shape, name_
        assert str(g.dtype).split(".")[1] == str(dtypes[name_]), name_
        np.testing.assert_allclose(f32(g).std(), w.std(), rtol=0.1,
                                   atol=1e-7, err_msg=name_)


@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_and_loss_equal_reference(name):
    """forward's logits and aux, forward_hidden, the loss, its metrics
    and every gradient."""
    ref = reference(name)
    model = port_model(name)
    tok, tgt = torch.as_tensor(ref["tok"]), torch.as_tensor(ref["tgt"])
    with torch.no_grad():
        logits, aux = model(tok)
        hidden, hidden_aux = model.forward_hidden(tok)
    close(logits, ref["logits"], FWD, "logits")
    close(aux, ref["aux"], FWD, "aux")
    close(hidden, ref["hidden"], FWD, "hidden")
    close(hidden_aux, ref["hidden_aux"], FWD, "hidden aux")
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss_fn(tok, tgt)
    loss.backward()
    close(loss, ref["loss"], FWD, "loss")
    for k in ("ce", "aux", "loss"):
        close(metrics[k], ref["metrics"][k], FWD, k)
    close_grads(grads_to_numpy(model), ref["grads"], ref["params"])
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", ["gemma2-27b", "tinyllama-1.1b"])
def test_chunked_ce_equals_reference(name):
    """``ce_chunk`` > 0: the unembedding and CE a chunk of 4 positions at a
    time (tied with a final softcap; untied)."""
    jcfg, tcfg = configs(name)
    jcfg, tcfg = jcfg.scaled(ce_chunk=4), tcfg.scaled(ce_chunk=4)
    params, model = carried(jcfg, tcfg)
    tok = tokens(4, (B, 16), jcfg.vocab)
    tgt = np.roll(tok, -1, axis=1)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: JMod.loss_fn(p, jcfg, jnp.asarray(tok), jnp.asarray(tgt)),
        has_aux=True))(params)
    loss, metrics = model.loss_fn(torch.as_tensor(tok), torch.as_tensor(tgt))
    loss.backward()
    close(loss, want, FWD)
    close(metrics["ce"], want_m["ce"], FWD)
    close_grads(grads_to_numpy(model), want_g, params)


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_equal_reference(name):
    """prefill's last logits and cache, then three decode steps' logits
    and caches (the cache one slot longer than needed)."""
    ref = reference(name)
    model = port_model(name)
    seq = torch.as_tensor(ref["seq"])
    with torch.no_grad():
        last, cache = model.prefill(seq[:, :S], S + STEPS + 1)
        close(last, ref["prefill"][0], FWD, "prefill logits")
        assert set(cache) == set(ref["prefill"][1])
        for k in cache:
            close(cache[k], ref["prefill"][1][k], FWD, f"prefill {k}")
        for i, (want_logits, want_cache) in enumerate(ref["steps"]):
            before = {k: v.clone() for k, v in cache.items()}
            logits, new = TDec.serve_step(model, cache, seq[:, S + i], S + i)
            for k in cache:      # the caller's cache is left as it was
                assert torch.equal(cache[k], before[k])
            cache = new
            close(logits, want_logits, FWD, f"step {i} logits")
            for k in cache:
                close(cache[k], want_cache[k], FWD, f"step {i} {k}")


@pytest.mark.parametrize("name", list(ARCHS))
def test_generate_equals_reference(name):
    """Greedy ids, and sampled ids from the same key: the sampler draws
    JAX's Gumbel noise bit for bit, so the ids are equal."""
    ref = reference(name)
    model = port_model(name)
    prompts = torch.as_tensor(ref["seq"][:, :S])
    greedy = TDec.generate(model, prompts, 6)
    sampled = TDec.generate(model, prompts, 6, greedy=False,
                            rng=_threefry.seed_key(5))
    assert greedy.dtype == torch.int32 and greedy.shape == (B, 6)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref["greedy"]))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(ref["sampled"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_noise_equals_reference(dtype):
    """The sampler's noise for a key: JAX's uniform exactly, the Gumbel
    transform within 2 ulp of max(|g|, 1) (torch's ``log`` may round the
    last bit differently from XLA's: measured at most 1 such ulp in
    float32, none in bfloat16)."""
    tdt = getattr(torch, dtype)
    key = jax.random.PRNGKey(9)
    for _ in range(3):
        key, sub = jax.random.split(key)
        want_u = jax.random.uniform(sub, (3, 500), jnp.dtype(dtype),
                                    minval=jnp.finfo(dtype).tiny, maxval=1.0)
        want_g = jax.random.gumbel(sub, (3, 500), jnp.dtype(dtype))
        tkey = (np.uint32(np.asarray(jax.random.key_data(sub))[0]),
                np.uint32(np.asarray(jax.random.key_data(sub))[1]))
        got_u = TDec.uniform(tkey, (3, 500), tdt)
        got_g = TDec.gumbel(tkey, (3, 500), tdt)
        np.testing.assert_array_equal(f32(got_u), f32(want_u))
        ulp = np.spacing(np.maximum(np.abs(f32(want_g)), 1.0)) * (
            2.0 ** 16 if dtype == "bfloat16" else 1.0)
        assert (np.abs(f32(got_g) - f32(want_g)) <= 2 * ulp).all()
    logits = np.random.default_rng(0).normal(size=(4, 300)).astype(np.float32)
    _, sub = jax.random.split(jax.random.PRNGKey(3))
    want = jax.random.categorical(sub, jnp.asarray(logits))
    k = np.asarray(jax.random.key_data(sub))
    got = TDec.categorical((np.uint32(k[0]), np.uint32(k[1])),
                           torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["gemma2-27b", "tinyllama-1.1b",
                                  "moonshot-v1-16b-a3b"])
def test_bf16_equals_reference(name):
    """bfloat16 compute (``dtype="bfloat16"``; softcaps and GeGLU, a dense
    SwiGLU, an MoE): logits and aux within ``BF16_FWD``, the loss within
    1e-3, the measured gap of bf16 matmuls and sums rounded in another
    order than XLA's."""
    jcfg, tcfg = configs(name)
    jcfg = jcfg.scaled(dtype="bfloat16")
    tcfg = tcfg.scaled(dtype="bfloat16")
    params, model = carried(jcfg, tcfg)
    tok = tokens(1, (B, 16), jcfg.vocab)
    tgt = np.roll(tok, -1, axis=1)
    want, want_aux = JMod.forward(params, jcfg, jnp.asarray(tok))
    want_loss, _ = JMod.loss_fn(params, jcfg, jnp.asarray(tok),
                                jnp.asarray(tgt))
    with torch.no_grad():
        got, aux = model(torch.as_tensor(tok))
        loss, _ = model.loss_fn(torch.as_tensor(tok),
                                torch.as_tensor(tgt))
    assert got.dtype == torch.bfloat16
    close_scaled(got, want, BF16_FWD, name)
    close_scaled(aux, want_aux, BF16_FWD, name)
    close(loss, want_loss, dict(rtol=1e-3, atol=1e-3), name)


def _reference_moe_keep(mp, flat, moe_cfg):
    """The reference's slot-keep mask for one MoE call, by its own
    routing steps (``src/repro/models/transformer/moe.py:35-49``)."""
    t = flat.shape[0]
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    c = max(8, int(t * k / e * moe_cfg.capacity_factor))
    probs = jax.nn.softmax(jnp.einsum("td,de->te", flat, mp["router"])
                           .astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    se = eidx.reshape(-1)[jnp.argsort(eidx.reshape(-1))]
    counts = jax.ops.segment_sum(jnp.ones_like(se), se, num_segments=e)
    pos = jnp.arange(t * k) - (jnp.cumsum(counts) - counts)[se]
    return np.asarray(pos < c)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_moe_capacity_drops_equal_reference(name):
    """capacity_factor 0.5: tokens are dropped; the logits, aux and each
    layer's dropped-slot count equal the reference's."""
    jcfg, tcfg = configs(name)
    jcfg = jcfg.scaled(moe=jcfg.moe.__class__(
        **{**vars(jcfg.moe), "capacity_factor": 0.5}))
    tcfg = tcfg.scaled(moe=tcfg.moe.__class__(
        **{**vars(tcfg.moe), "capacity_factor": 0.5}))
    params, model = carried(jcfg, tcfg)
    tok = tokens(6, (B, 16), jcfg.vocab)

    seen_j, seen_t = [], []

    def hook_j(x, kind):
        if kind == "moe_call":
            seen_j.append(x)
        return x

    def hook_t(x, kind):
        if kind == "moe_call":
            seen_t.append(x)
        return x
    with jax.disable_jit():    # eager layers (no remat: same values)
        want, want_aux = JMod.forward(params, jcfg.scaled(remat=False),
                                      jnp.asarray(tok), constrain=hook_j)
    with torch.no_grad():
        got, aux = model(torch.as_tensor(tok), constrain=hook_t)
    close(got, want, FWD)
    close(aux, want_aux, FWD)
    assert len(seen_j) == len(seen_t) == tcfg.n_layers
    drops = []
    for (mp_j, flat_j), (mp_t, flat_t) in zip(seen_j, seen_t):
        close(flat_t, flat_j, FWD)
        keep_j = _reference_moe_keep(mp_j, flat_j, jcfg.moe)
        keep_t = TMoE.route(mp_t, flat_t, tcfg.moe)["keep"].numpy()
        np.testing.assert_array_equal(keep_t, keep_j)
        drops.append(int((~keep_t).sum()))
    assert sum(drops) > 0, drops


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_ffn_equals_reference(cf):
    """``moe_ffn`` alone on random tokens, arctic's SMOKE experts with
    its dense branch and moonshot's shared expert, with and without
    drops: output and aux."""
    rng = np.random.default_rng(7)
    for name in ("moonshot-v1-16b-a3b", "arctic-480b"):
        jcfg, tcfg = configs(name)
        jm = jcfg.moe.__class__(**{**vars(jcfg.moe), "capacity_factor": cf})
        tm = tcfg.moe.__class__(**{**vars(tcfg.moe), "capacity_factor": cf})
        p = JMoE.init_moe_params(jax.random.PRNGKey(1), 64, jm, jnp.float32)
        x = rng.normal(size=(40, 64)).astype(np.float32)
        want_y, want_aux = JMoE.moe_ffn(p, jnp.asarray(x), jm, jax.nn.silu)
        tp = {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
        got_y, got_aux = TMoE.moe_ffn(tp, torch.as_tensor(x), tm,
                                      torch.nn.functional.silu)
        close(got_y, want_y, FWD, name)
        close(got_aux, want_aux, FWD, name)


def test_gemma2_ring_wraps_past_the_window():
    """gemma2 (window 8): prefill 4 tokens, then 12 decode steps, so the
    local layers' ring buffer wraps; logits and caches equal the
    reference's every step, and the last step equals the forward."""
    jcfg, tcfg = configs("gemma2-27b")
    params, model = carried(jcfg, tcfg)
    s0, n = 4, 12
    seq = tokens(7, (B, s0 + n), jcfg.vocab)
    want_last, want_cache = JMod.prefill(params, jcfg, jnp.asarray(seq[:, :s0]),
                                         s0 + n)
    with torch.no_grad():
        last, cache = model.prefill(torch.as_tensor(seq[:, :s0]), s0 + n)
        close(last, want_last, FWD)
        assert cache["k_local"].shape[2] == 8
        for i in range(n):
            want, want_cache = JDec.serve_step(params, jcfg, want_cache,
                                               jnp.asarray(seq[:, s0 + i]),
                                               jnp.int32(s0 + i))
            got, cache = model.decode_step(
                cache, torch.as_tensor(seq[:, s0 + i]), s0 + i)
            close(got, want, FWD, f"step {i}")
            for k in cache:
                close(cache[k], want_cache[k], FWD, f"step {i} {k}")
        full, _ = model(torch.as_tensor(seq))
    close(got, full[:, -1], dict(rtol=2e-3, atol=2e-3))


def test_cache_write_past_the_end_clamps_as_the_reference():
    """A linear cache of S slots written at pos >= S: the slot is clamped
    to the last one (``dynamic_update_slice``), not an index error."""
    jcfg, tcfg = configs("qwen1.5-0.5b")
    params, model = carried(jcfg, tcfg)
    seq = tokens(8, (B, 8), jcfg.vocab)
    _, want_cache = JMod.prefill(params, jcfg, jnp.asarray(seq[:, :6]), 6)
    with torch.no_grad():
        _, cache = model.prefill(torch.as_tensor(seq[:, :6]), 6)
        for pos in (6, 7):
            want, want_cache = JMod.decode_step(
                params, jcfg, want_cache, jnp.asarray(seq[:, pos]),
                jnp.int32(pos))
            got, cache = model.decode_step(cache,
                                           torch.as_tensor(seq[:, pos]), pos)
            close(got, want, FWD, f"pos {pos}")
            for k in cache:
                close(cache[k], want_cache[k], FWD, f"pos {pos} {k}")


def test_rope_and_attention_equal_reference():
    """apply_rope; chunked_attention over several kv chunks (causal, a
    window, a softcap); decode_attention on a linear cache with a window
    and on a ring."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    pos = np.arange(100, 116, dtype=np.int32)
    close(TRope.apply_rope(torch.as_tensor(x), torch.as_tensor(pos)[None],
                           5e5),
          JRope.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None], 5e5), FWD)
    q, k, v = (rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    p = np.arange(16, dtype=np.int32)
    for kw in (dict(), dict(window=5, softcap=2.0), dict(causal=False)):
        want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(p),
                                    jnp.asarray(p), kv_chunk=4, **kw)
        got = TA.chunked_attention(*map(torch.as_tensor, (q, k, v, p, p)),
                                   kv_chunk=4, **kw)
        close(got, want, FWD, str(kw))
    with pytest.raises(ValueError):
        TA.chunked_attention(*map(torch.as_tensor, (q, k, v, p, p)),
                             kv_chunk=5)
    qd = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 10, 2, 8)).astype(np.float32)
              for _ in range(2))
    for pos_, kw in ((6, dict(window=3, softcap=5.0)), (13, dict(ring=True)),
                     (4, dict(ring=True))):
        want = JA.decode_attention(jnp.asarray(qd), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.int32(pos_), **kw)
        got = TA.decode_attention(torch.as_tensor(qd), torch.as_tensor(kc),
                                  torch.as_tensor(vc), pos_, **kw)
        close(got, want, FWD, f"{pos_} {kw}")


# --------------------------------------------------------------- the twin
@pytest.mark.parametrize("vocab", [256, 32_000])
def test_example_prompts_equal_jax_randint(vocab):
    """The twin's prompts, ``_threefry.randint(1, (4, 32), 0, vocab)``,
    are ``jax.random.randint(PRNGKey(1), (4, 32), 0, vocab)``."""
    np.testing.assert_array_equal(
        _threefry.randint(1, (4, 32), 0, vocab),
        np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                      vocab)))


def _run_example(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def test_example_twin_runs_on_the_cpu():
    out = _run_example("examples/serve_lm_torch.py", "--device", "cpu",
                       "--steps", "8")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.rstrip().endswith("OK"), out.stdout[-2000:]


def test_example_twin_asks_for_cuda_by_default():
    """Without ``--device`` the twin runs on CUDA; where there is none it
    fails and names the CPU opt-in rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = _run_example("examples/serve_lm_torch.py")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert "OK" not in out.stdout
