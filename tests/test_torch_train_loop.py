"""The port's training loop, data pipelines, checkpoints and restart glue
(``repro_torch.train.{loop,data,checkpoint,elastic}``) held against the
JAX package, twins of ``tests/test_train_substrate.py``'s loop and
checkpoint tests, and the launcher and example twin as subprocesses.

The state crosses from the reference by its leaves in
``jax.tree.flatten`` order (``checkpoint.from_numpy_leaves``), so both
packages start from one state: the reference's ``init_params`` carried
into the port's ``Transformer`` and the optimizer state beside it.

Tolerances.  Train steps on the SMOKE configs (float32 compute): every
float32 state leaf within the reference test's rtol 2e-4, atol 2e-5;
every bfloat16 leaf within two bfloat16 ulps of the value plus half an
ulp of the leaf's largest (as ``test_torch_models_lm.py`` holds bf16
gradients); ``loss`` within rtol 1e-5, ``lr`` 1e-6, ``grad_norm`` 1e-4
(float32 weights) or 2**-6 (bfloat16 weights: a sum of bf16 gradients).
tinyllama (float32 weights) takes three successive steps on each side.
gemma2 stores bfloat16 weights: a float32 ulp of difference can round an
updated weight to the neighbouring bf16 value, and the next forward
carries that into every gradient, so each of its three steps starts from
the reference's state before it.  The gradient codecs turn a float32 ulp
of gradient noise into a whole quantum at a rounding boundary (measured
on tinyllama SMOKE: 1-22 elements a quantum apart after 1-3 steps), so
the codec steps take the SMOKE parameter tree with a quadratic loss
whose gradient ``2 (w - t)`` is exact on both sides, each step from the
reference's state before it (a float32 ulp in a weight also moves
``2 (w - t)`` across a bf16 boundary now and then: one element of 16 384
after three chained steps), and hold the state at the optimizer's rtol
1e-6, atol 1e-7.
"""
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_27b as JG
from repro.configs import mind as JMind
from repro.configs import tinyllama_11b as JT
from repro.models.transformer import model as JM
from repro.train import checkpoint as JCk
from repro.train import data as JD
from repro.train import elastic as JE
from repro.train import loop as JL
from repro.train import optim as JO
from repro_torch.configs import gemma2_27b as TG
from repro_torch.configs import mind as TMind
from repro_torch.configs import tinyllama_11b as TT
from repro_torch.core._threefry import fold_in, seed_key
from repro_torch.models.params import (load_numpy_params, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.models.transformer.model import Transformer
from repro_torch.train import checkpoint as TCk
from repro_torch.train import data as TD
from repro_torch.train import elastic as TE
from repro_torch.train import loop as TL
from repro_torch.train import optim as TO

ROOT = Path(__file__).resolve().parents[1]
CFG = TT.SMOKE
STEP = dict(rtol=2e-4, atol=2e-5)
OPT = dict(rtol=1e-6, atol=1e-7)
SUBPROCESS_TIMEOUT_S = 240
CASES = {"tinyllama": (JT.SMOKE, TT.SMOKE, "adamw"),
         "gemma2": (JG.SMOKE, TG.SMOKE, "adafactor")}


def _np(x):
    """A leaf as numpy; bfloat16 as its bits (int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _same_leaves(got, want):
    got, want = tree_leaves(got), list(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def _close_state(got, want_leaves, tol, msg):
    """Every leaf: bfloat16 within 2 ulps + half an ulp of the leaf's
    largest, integers equal, float32 within ``tol``."""
    got = tree_leaves(got)
    assert len(got) == len(want_leaves)
    for i, (a, w) in enumerate(zip(got, want_leaves)):
        if w.dtype == jnp.bfloat16:
            w = _f64(w)
            bound = 2.0 ** -6 * np.abs(w) + 2.0 ** -9 * np.abs(w).max()
            assert (np.abs(_f64(a) - w) <= bound).all(), (msg, i)
        elif np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(_np(a), _np(w), err_msg=msg)
        else:
            np.testing.assert_allclose(_f64(a), _f64(w), err_msg=f"{msg} "
                                       f"leaf {i}", **tol)


def _carried(name, opt_seed=1):
    """(reference state, the port's state from its leaves, port model)."""
    jcfg, tcfg, opt = CASES[name]
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    js = JL.init_state(jax.random.PRNGKey(opt_seed), params, opt)
    model = Transformer(tcfg, device="cpu")
    load_numpy_params(model, jax.tree.map(np.asarray, params))
    like = TL.init_state(seed_key(0), model.params, opt)
    return js, TCk.from_numpy_leaves(like, _leaves(js)), model


def _leaves(jstate):
    return [np.asarray(x) for x in jax.tree.leaves(jstate)]


def _jax_loss(cfg):
    return lambda p, b, r: JM.loss_fn(p, cfg, b["tokens"], b["targets"])


# ------------------------------------------------------- fold_in and data
def test_fold_in_bitwise():
    for seed in (0, 1, 7, -3, 2 ** 31 - 1):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(key), np.array(seed_key(seed)))
        for data in (0, 1, 3, 12345, 2 ** 31 - 1):
            want = np.asarray(jax.random.fold_in(key, jnp.int32(data)))
            got = fold_in(np.asarray(key), data)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shard,num_shards,accum",
                         [(0, 1, 1), (1, 2, 1), (0, 1, 3), (3, 4, 2)])
def test_lm_batches_bitwise(shard, num_shards, accum):
    kw = dict(seed=5, shard=shard, num_shards=num_shards, accum=accum)
    want = JD.lm_batches(JT.SMOKE, 8, 12, **kw)
    got = TD.lm_batches(TT.SMOKE, 8, 12, device="cpu", **kw)
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("with_geom,max_triplets",
                         [(True, 0), (True, 300), (False, 300)])
def test_gnn_full_batches_bitwise(with_geom, max_triplets):
    kw = dict(seed=2, with_geom=with_geom, max_triplets=max_triplets)
    w = next(JD.gnn_full_batches(60, 240, 5, 4, **kw))
    g = next(TD.gnn_full_batches(60, 240, 5, 4, device="cpu", **kw))
    assert set(w) == set(g)
    for k in w:
        want = np.asarray(w[k])
        assert g[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(g[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_recsys_batches_bitwise(shard, num_shards):
    jcfg = JMind.CONFIG.scaled(n_items=5000)
    tcfg = TMind.CONFIG.scaled(n_items=5000)
    kw = dict(seed=4, shard=shard, num_shards=num_shards)
    want = JD.recsys_batches(jcfg, 16, **kw)
    got = TD.recsys_batches(tcfg, 16, device="cpu", **kw)
    for _ in range(2):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        for k in w:
            assert g[k].numpy().dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# -------------------------------------------------- steps on the models
@pytest.mark.parametrize("name,accum,chained", [
    ("tinyllama", 1, True), ("tinyllama", 2, True), ("gemma2", 1, False)])
def test_train_steps_equal_reference(name, accum, chained):
    """One step, then three: the state and the metrics after each."""
    jcfg, tcfg, opt = CASES[name]
    js, ts, model = _carried(name)
    sched = dict(base_lr=1e-2, warmup=1, total=50)
    jstep = JL.make_train_step(_jax_loss(jcfg), optimizer=opt, accum=accum,
                               lr_schedule=JO.cosine_schedule(**sched),
                               donate=False)
    tstep = TL.make_train_step(TL.lm_loss(model), optimizer=opt,
                               accum=accum, donate=False,
                               lr_schedule=TO.cosine_schedule(**sched))
    jdata = JD.lm_batches(jcfg, 4, 16, seed=3, accum=accum)
    tdata = TD.lm_batches(tcfg, 4, 16, seed=3, accum=accum, device="cpu")
    bf16 = any(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(js))
    for i in range(3):
        if not chained:   # this step starts from the reference's state
            ts = TCk.from_numpy_leaves(ts, _leaves(js))
        js, jm = jstep(js, next(jdata))
        ts, tm = tstep(ts, next(tdata))
        _close_state(ts, _leaves(js), STEP, f"{name} step {i}")
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=2.0 ** -6 if bf16 else 1e-4)
        assert int(ts.step) == i + 1


def _quad(leaves_of, sq, sm, cast):
    def loss_fn(params, batch, rng):
        loss = sum(sm(sq(cast(p) - t)) for p, t in zip(
            leaves_of(params), leaves_of(batch["target"])))
        return loss, {"loss": loss}
    return loss_fn


@pytest.mark.parametrize("codec,accum", [("none", 1), ("bf16", 1),
                                         ("int8", 1), ("int8", 2)])
def test_codec_steps_equal_reference(codec, accum):
    """Three steps with each gradient codec on the SMOKE parameter tree,
    from a loss whose gradient is exact on both sides, each from the
    reference's state."""
    js, ts, _ = _carried("tinyllama")
    rng = np.random.default_rng(8)
    jloss = _quad(jax.tree.leaves, jnp.square, jnp.sum,
                  lambda p: p.astype(jnp.float32))
    tloss = _quad(tree_leaves, torch.square, torch.sum, lambda p: p.float())
    sched = dict(base_lr=1e-2, warmup=1, total=50)
    kw = dict(optimizer="adamw", accum=accum, grad_codec=codec)
    jstep = JL.make_train_step(jloss, lr_schedule=JO.cosine_schedule(
        **sched), donate=False, **kw)
    tstep = TL.make_train_step(tloss, lr_schedule=TO.cosine_schedule(
        **sched), **kw)
    lead = (accum,) if accum > 1 else ()
    for i in range(3):
        ts = TCk.from_numpy_leaves(ts, _leaves(js))
        tgt = [rng.normal(size=lead + x.shape).astype(np.float32) * 0.1
               for x in _leaves(js.params)]
        js, jm = jstep(js, {"target": jax.tree.unflatten(
            jax.tree.structure(js.params),
            [jnp.asarray(t) for t in tgt])})
        ts, tm = tstep(ts, {"target": [torch.tensor(t) for t in tgt]})
        _close_state(ts, _leaves(js), OPT, f"{codec} step {i}")
        for k, rtol in (("loss", 1e-5), ("lr", 1e-6), ("grad_norm", 1e-5)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, err_msg=k)


def test_remat_gradient_equals_without():
    """``cfg.remat`` recomputes each layer from the swapped tensors."""
    data = next(TD.lm_batches(CFG, 4, 16, seed=1, device="cpu"))
    grads = []
    for remat in (True, False):
        model = Transformer(CFG.scaled(remat=remat), seed=3, device="cpu")
        loss_fn = TL.lm_loss(model)
        params = tree_map(lambda v: v * 1.5, model.params)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves), data, None)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_state_shardings_are_not_ported():
    """``state_shardings`` is ported: on a mesh of one rank (no process
    group is touched) the sharded step is the unsharded one, bitwise."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import lm_state_shardings
    mesh = Mesh(("data", "model"), (1, 1), (0, 0), torch.device("cpu"))
    model = Transformer(CFG, seed=4, device="cpu")
    data = next(TD.lm_batches(CFG, 4, 16, seed=2, device="cpu"))
    kw = dict(optimizer="adamw", lr_schedule=lambda s: 1e-2, donate=False)
    state = TL.init_state(seed_key(1), model.params)
    step = TL.make_train_step(TL.lm_loss(model), **kw)
    sharded = TL.make_train_step(TL.lm_loss(model), **kw,
                                 state_shardings=lm_state_shardings(
                                     state, mesh))
    (a, ma), (b, mb) = step(state, data), sharded(state, data)
    _same_leaves(b, tree_leaves(a))
    for k in ma:
        assert float(ma[k]) == float(mb[k]), k


# ------------------------------------------------- twins of the JAX tests
def test_grad_accum_matches_large_batch():
    """accum=4 over microbatches == one big batch (same grads, fp32), on
    the reference test's inputs: its ``init_params(PRNGKey(0))`` carried
    in.  The check is sensitive to the values: an element whose gradient
    is near AdamW's eps (1e-8) turns float32 summation noise into a
    visible first update, and the reference's own test reaches 1.10x and
    1.06x its tolerance at ``PRNGKey(3)`` and ``(4)``."""
    model = Transformer(CFG, device="cpu")
    load_numpy_params(model, jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(0), JT.SMOKE)))
    data = next(TD.lm_batches(CFG, batch=8, seq=16, accum=4, device="cpu"))
    big = {k: v.reshape(-1, v.shape[-1]) for k, v in data.items()}
    kw = dict(optimizer="adamw", lr_schedule=lambda s: 1e-2, donate=False)
    step_a = TL.make_train_step(TL.lm_loss(model), accum=4, **kw)
    step_b = TL.make_train_step(TL.lm_loss(model), accum=1, **kw)
    sa2, _ = step_a(TL.init_state(seed_key(1), model.params), data)
    sb2, _ = step_b(TL.init_state(seed_key(1), model.params), big)
    for a, b in zip(tree_leaves(sa2.params), tree_leaves(sb2.params)):
        np.testing.assert_allclose(_f64(a), _f64(b), **STEP)


def test_checkpoint_restart_bitwise(tmp_path):
    """Kill-and-restart: state restored from disk continues bit-identically."""
    model = Transformer(CFG, seed=0, device="cpu")
    step_fn = TL.make_train_step(
        TL.lm_loss(model), optimizer="adamw",
        lr_schedule=TO.cosine_schedule(1e-3, 2, 100), donate=False)
    state = TL.init_state(seed_key(7), model.params)
    data = TD.lm_batches(CFG, batch=4, seq=16, seed=3, device="cpu")
    batches = [next(data) for _ in range(6)]

    s = state
    for b in batches[:3]:
        s, _ = step_fn(s, b)
    TCk.save(s, str(tmp_path), int(s.step))
    ref = s
    for b in batches[3:]:
        ref, _ = step_fn(ref, b)

    restored = TCk.restore(str(tmp_path), s)
    assert int(restored.step) == 3
    s2 = restored
    for b in batches[3:]:
        s2, _ = step_fn(s2, b)
    _same_leaves(s2, tree_leaves(ref))


def test_checkpoint_atomic_and_gc(tmp_path):
    state = {"w": torch.arange(10, dtype=torch.float32)}
    for step in (1, 2, 3, 4, 5):
        TCk.save(state, str(tmp_path), step, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step-"))
    assert kept == ["step-000000004", "step-000000005"]
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp-")]
    assert TCk.latest_step(str(tmp_path)) == 5
    assert TCk.latest_step(str(tmp_path / "none")) is None


def test_deterministic_data_restart():
    a = TD.lm_batches(CFG, batch=4, seq=8, seed=5, device="cpu")
    b = TD.lm_batches(CFG, batch=4, seq=8, seed=5, device="cpu")
    for _ in range(3):
        next(b)
    x3 = next(a), next(a), next(a), next(a)
    y = next(b)
    assert torch.equal(x3[3]["tokens"], y["tokens"])


# ---------------------------------------------------------- checkpoints
@pytest.mark.parametrize("name", list(CASES))
def test_restores_reference_checkpoint(tmp_path, name):
    """A checkpoint the JAX package writes (float32 and, for gemma2,
    bfloat16 leaves as ``|V2``) restored leaf for leaf, ``step`` and
    ``rng`` included; the port's own checkpoint of it holds the same
    arrays under the same keys."""
    jcfg, _, opt = CASES[name]
    js, ts, model = _carried(name, opt_seed=11)
    jstep = JL.make_train_step(_jax_loss(jcfg), optimizer=opt, donate=False,
                               lr_schedule=lambda s: 1e-2)
    js, _ = jstep(js, next(JD.lm_batches(jcfg, 2, 8, seed=1)))
    JCk.save(js, str(tmp_path / "ref"), 1)
    like = TL.init_state(seed_key(0), model.params, opt)
    restored = TCk.restore(str(tmp_path / "ref"), like)
    _same_leaves(restored, _leaves(js))
    assert isinstance(restored.step, np.int32) and restored.step == 1
    np.testing.assert_array_equal(restored.rng,
                                  np.asarray(jax.random.PRNGKey(11)))
    TCk.save(restored, str(tmp_path / "port"), 1)
    want = np.load(tmp_path / "ref" / "step-000000001" / "arrays.npz")
    got = np.load(tmp_path / "port" / "step-000000001" / "arrays.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    if name == "gemma2":
        assert any(want[k].dtype == np.dtype("V2") for k in want.files)


def test_async_save_then_inplace_step(tmp_path, monkeypatch):
    """``save(blocking=False)`` copies the state before its writer starts:
    a donated (in-place) step taken at once leaves the saved leaves equal
    to the state before the step.  The writer is held until the step has
    run."""
    model = Transformer(CFG, seed=2, device="cpu")
    state = TL.init_state(seed_key(3), model.params)
    step_fn = TL.make_train_step(TL.lm_loss(model), optimizer="adamw",
                                 lr_schedule=lambda s: 1e-2, donate=True)
    before = [_np(x).copy() for x in tree_leaves(state)]
    stepped = threading.Event()
    savez = np.savez

    def held_savez(*args, **kw):
        assert stepped.wait(60)
        return savez(*args, **kw)
    monkeypatch.setattr(np, "savez", held_savez)
    writer = TCk.save(state, str(tmp_path), 0, blocking=False)
    new, _ = step_fn(state, next(TD.lm_batches(CFG, 4, 16, device="cpu")))
    stepped.set()
    writer.join(60)
    assert not writer.is_alive()
    w = tree_leaves(new.params)[0]
    assert w is tree_leaves(state.params)[0]   # updated in place
    assert not np.array_equal(_np(w), before[0])
    _same_leaves(TCk.restore(str(tmp_path), state), before)


def test_resume_on_mesh_places_every_leaf(tmp_path):
    model = Transformer(CFG, seed=2, device="cpu")
    state = TL.init_state(seed_key(3), model.params)
    TCk.save(state, str(tmp_path), 4)
    seen = []

    def placement(like, mesh):
        seen.append(mesh)
        return tree_map(lambda _: torch.device("cpu"), like)
    out = TE.resume_on_mesh(str(tmp_path), state, "mesh", placement)
    assert seen == ["mesh"]
    _same_leaves(out, tree_leaves(state))


def test_step_watchdog_flags_as_reference(monkeypatch):
    """Both watchdogs on one recorded sequence of step times."""
    times = [1.0, 1.1, 0.9, 1.0, 1.0, 4.0, 1.0, 2.9, 3.5, 1.0, 9.0, 1.2]
    flags = {}
    for name, mod in (("jax", JE), ("torch", TE)):
        clock = iter(np.cumsum([0.0] + [t for dt in times
                                         for t in (dt, 0.0)]).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        dog = mod.StepWatchdog(factor=3.0, window=8)
        out = []
        for step in range(len(times)):
            dog.start()
            out.append(dog.stop(step))
        flags[name] = (out, dog.flagged)
    assert flags["torch"] == flags["jax"]
    assert flags["torch"][1] == [5, 8, 10]


# ------------------------------------------ the launcher and the twin
def _run(args):
    """One process, one thread: the suite runs beside other workers."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, out + err
    return out.strip().splitlines()


def test_launcher_and_example_twin_on_cpu():
    ck = tempfile.mkdtemp(prefix="launch_ckpt_")
    ck2 = tempfile.mkdtemp(prefix="twin_ckpt_")
    launch = ["-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
              "--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
              "--seq", "32", "--ckpt-dir", ck, "--ckpt-every", "2"]
    first = _run(launch)
    twin = _run(["examples/train_lm_torch.py", "--device", "cpu", "--steps",
                 "4", "--batch", "2", "--seq", "16", "--ckpt-dir", ck2])
    out = _finish(first)
    assert out[-1] == "done at step 4"
    assert TCk.latest_step(ck) == 4
    out = _finish(_run(launch + ["--resume"]))
    assert "resumed from step 4" in out and out[-1] == "done at step 8"
    out = _finish(twin)   # its hook saves every 50 steps, as the reference's
    assert out[0].endswith("params for 4 steps")
    assert out[-1] == "final checkpoint at step None"
