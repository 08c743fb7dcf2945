"""The sharded train state (``train.loop.make_train_step(
state_shardings=)``, ``train.elastic.resume_on_mesh``) over 4 gloo ranks
on mesh (2, 2), held against the port's single-process step and the JAX
package's.

The file is also the script of both sides, started by pytest at once:
``python <file> torch <dir>`` spawns 4 gloo ranks (``FileStore``, a 120 s
group timeout) on mesh (2, 2), then rank 0 alone on mesh (1, 1);
``python <file> jax <dir>`` runs the reference under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.  pytest first
writes every case's initial state as a whole checkpoint (the port's
``Transformer`` from a seed, ``init_state``), which both sides load, and
the global batches.

Cases, two steps each (``cosine_schedule(1e-2, 1, 50)``, batch 4 x 16,
every rank feeding its data block of rows):
- ``tinyllama``: SMOKE, AdamW, float32 weights;
- ``moonshot_noaux``: SMOKE with ``moe_impl="shard_map"``, Adafactor,
  bfloat16 weights, no drops (capacity factor 8), ``router_aux_weight``
  0: the same function as the unsharded step;
- ``moonshot``: as above with the aux loss (weight 0.01), whose per-rank
  estimator only the reference's sharded step computes: held against
  ``make_train_step(state_shardings=lm_state_shardings(...))`` of the
  JAX package on mesh (2, 2) with its ``moe_ffn_sharded`` in the
  ``"moe_call"`` hook, as its ``launch.cells`` builds it.
The gathered state within ``test_torch_train_loop.py``'s STEP (rtol
2e-4, atol 2e-5; bfloat16 leaves within 2 ulps of the value + half an
ulp of the leaf's largest), ``loss`` rtol 1e-5 and ``grad_norm`` 1e-4
(float32 weights) or 2**-6 (bfloat16) after each step.  On mesh (1, 1)
the sharded step equals the unsharded one bit for bit (``tinyllama`` and
moonshot with ``moe_impl="pjit"``).  ``resume_on_mesh`` gives each rank
exactly its shard of a whole checkpoint.
"""
import json
import os
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SHAPE = (2, 2)
AXES = ("data", "model")
STEPS = 2
BATCH, SEQ = 4, 16
SCHED = dict(base_lr=1e-2, warmup=1, total=50)
GROUP_TIMEOUT_S = 120
RUN_TIMEOUT_S = 400
STEP = dict(rtol=2e-4, atol=2e-5)
CASES = ("tinyllama", "moonshot_noaux", "moonshot")
BITWISE = ("tinyllama", "moonshot_pjit")


def _cfg(case, jax_side=False):
    """(config, optimizer) of a case, from either package."""
    if jax_side:
        from repro.configs import moonshot_v1_16b_a3b as MS
        from repro.configs import tinyllama_11b as TL
    else:
        from repro_torch.configs import moonshot_v1_16b_a3b as MS
        from repro_torch.configs import tinyllama_11b as TL
    if case == "tinyllama":
        return TL.SMOKE, "adamw"
    cfg = MS.SMOKE.scaled(moe_impl="pjit" if case == "moonshot_pjit"
                          else "shard_map")
    if case == "moonshot_noaux":
        import dataclasses
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe,
                                                 router_aux_weight=0.0))
    return cfg, cfg.optimizer


def _model_and_state(case):
    from repro_torch.core._threefry import seed_key
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train.loop import init_state
    cfg, opt = _cfg(case)
    model = Transformer(cfg, seed=9, device="cpu")
    return model, init_state(seed_key(3), model.params, opt)


def _batches(case):
    from repro_torch.train.data import lm_batches
    cfg, _ = _cfg(case)
    data = lm_batches(cfg, BATCH, SEQ, seed=4, device="cpu")
    return [next(data) for _ in range(STEPS)]


def _step_fn(model, case, layouts=None, constrain=None):
    from repro_torch.train.loop import lm_loss, make_train_step
    from repro_torch.train.optim import cosine_schedule
    _, opt = _cfg(case)
    return make_train_step(lm_loss(model, constrain), optimizer=opt,
                           lr_schedule=cosine_schedule(**SCHED),
                           donate=False, state_shardings=layouts)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x)


def _save_leaves(path, tree):
    from repro_torch.models.params import tree_leaves
    np.savez(path, **{f"leaf_{i}": _np(x)
                      for i, x in enumerate(tree_leaves(tree))})


# -------------------------------------------------------------- the port
def _restore(case, out_dir, mesh):
    """The case's checkpoint restored as this rank's shards."""
    from repro_torch.launch.sharding import lm_state_shardings
    from repro_torch.train.elastic import resume_on_mesh
    model, like = _model_and_state(case)
    cfg, _ = _cfg(case)
    state = resume_on_mesh(
        os.path.join(out_dir, f"ckpt_{case}"), like, mesh,
        lambda like, mesh: lm_state_shardings(like, mesh,
                                              moe_impl=cfg.moe_impl))
    return model, like, state, lm_state_shardings(like, mesh,
                                                  moe_impl=cfg.moe_impl)


def _run_sharded(case, out_dir, mesh):
    from repro_torch.launch.cells import lm_constrain
    from repro_torch.launch.sharding import Layout, P, gather_tree, shard_tree
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.checkpoint import restore
    model, _, state, layouts = _restore(case, out_dir, mesh)
    whole = restore(os.path.join(out_dir, f"ckpt_{case}"),
                    _model_and_state(case)[1])
    exact = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state), tree_leaves(shard_tree(whole, layouts)))
        if isinstance(a, torch.Tensor))
    cfg, _ = _cfg(case)
    step = _step_fn(model, case, layouts, lm_constrain(cfg, mesh))
    rows = Layout(mesh, P(("data",), None))
    metrics = []
    for batch in _batches(case):
        state, m = step(state, {k: rows.shard(v) for k, v in batch.items()})
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return gather_tree(state, layouts), metrics, exact


def _rank_main(rank, world, out_dir):
    from repro_torch.launch.mesh import make_mesh_compat
    torch.set_num_threads(1)
    for shape in (SHAPE, (1, 1)):
        size = int(np.prod(shape))
        if rank >= size:
            return
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(
                out_dir, f"store_{size}"), size), rank=rank,
            world_size=size, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            mesh = make_mesh_compat(shape, AXES, device="cpu")
            cases = CASES if size > 1 else BITWISE
            report = {}
            for case in cases:
                state, metrics, exact = _run_sharded(case, out_dir, mesh)
                report[case] = {"metrics": metrics, "resume_exact": exact}
                if rank == 0:
                    _save_leaves(os.path.join(out_dir, f"port_{size}_{case}"
                                              ".npz"), state)
            with open(os.path.join(out_dir, f"rank{rank}_{size}.json"),
                      "w") as f:
                json.dump(report, f)
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------------- the JAX side
def _jax_state(case, out_dir, jax_cfg):
    """The case's checkpoint as a reference TrainState."""
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import model as JM
    from repro.train import loop as JL
    _, opt = _cfg(case)
    like = jax.eval_shape(lambda r: JL.init_state(
        r, JM.init_params(r, jax_cfg), opt), jax.random.PRNGKey(0))
    with np.load(os.path.join(out_dir, f"ckpt_{case}", "step-000000000",
                              "arrays.npz")) as f:
        leaves = [f[f"leaf_{i}"] for i in range(len(f.files))]
    fixed = [jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.dtype("V2")
                         else a, dtype=w.dtype)
             for a, w in zip(leaves, jax.tree.leaves(like))]
    return jax.tree.unflatten(jax.tree.structure(like), fixed)


def _jax_main(out_dir):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.launch import sharding as JSH
    from repro.launch.mesh import make_mesh_compat
    from repro.models.transformer import model as JM
    from repro.models.transformer.moe_sharded import moe_ffn_sharded
    from repro.train import loop as JL
    from repro.train import optim as JO

    assert len(jax.devices()) == WORLD
    batches = np.load(os.path.join(out_dir, "batches.npz"))
    mesh = make_mesh_compat(SHAPE, AXES)
    for case in CASES:
        cfg, opt = _cfg(case, jax_side=True)
        state = _jax_state(case, out_dir, cfg)
        sharded = case == "moonshot"

        def constrain(x, kind, cfg=cfg):
            if kind != "moe_call":
                return x
            mp, flat = x
            return moe_ffn_sharded(mp, flat, cfg.moe, JM._act(cfg.act),
                                   mesh=mesh, dp_axes=("data",),
                                   tp_axis="model")

        def loss(p, b, r, cfg=cfg, sharded=sharded):
            return JM.loss_fn(p, cfg, b["tokens"], b["targets"],
                              constrain=constrain if sharded else
                              JM._identity_constrain)
        kw = dict(optimizer=opt, lr_schedule=JO.cosine_schedule(**SCHED),
                  donate=False)
        if sharded:
            shard = JSH.lm_state_shardings(state, mesh)
            step = JL.make_train_step(loss, state_shardings=shard, **kw)
            state = jax.device_put(state, shard)
        else:
            step = JL.make_train_step(loss, **kw)
        out = {}
        for i in range(STEPS):
            batch = {k: batches[f"{case}/{i}/{k}"]
                     for k in ("tokens", "targets")}
            if sharded:
                batch = jax.device_put(batch, NamedSharding(
                    mesh, JP("data", None)))
                with mesh:
                    state, m = step(state, batch)
            else:
                state, m = step(state, batch)
            for k in ("loss", "grad_norm", "lr"):
                out[f"{i}/{k}"] = np.asarray(m[k])
        for j, x in enumerate(jax.tree.leaves(state)):
            x = np.asarray(x)
            out[f"leaf_{j}"] = x.view(np.int16) if x.dtype.name == \
                "bfloat16" else x
        np.savez(os.path.join(out_dir, f"jax_{case}.npz"), **out)


# ------------------------------------------------------------------- pytest
@pytest.fixture(scope="module")
def runs():
    from repro_torch.train import checkpoint as TCk
    out_dir = tempfile.mkdtemp(prefix="train_sharded_")
    single, batch_arrays = {}, {}
    for case in CASES + BITWISE:
        model, state = _model_and_state(case)
        TCk.save(state, os.path.join(out_dir, f"ckpt_{case}"), 0)
        batches = _batches(case)
        for i, b in enumerate(batches):
            for k, v in b.items():
                batch_arrays[f"{case}/{i}/{k}"] = v.numpy()
        if case != "moonshot":    # the port's single-process steps
            step = _step_fn(model, case)
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append({k: float(m[k]) for k in ("loss",
                                                         "grad_norm", "lr")})
            single[case] = (state, metrics)
    np.savez(os.path.join(out_dir, "batches.npz"), **batch_arrays)
    base = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}",
            "OMP_NUM_THREADS": "1"}
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, __file__, "jax", out_dir],
            env={**base, "JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                 f"--xla_force_host_platform_device_count={WORLD}"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "torch": subprocess.Popen(
            [sys.executable, __file__, "torch", out_dir], env=base,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise AssertionError(f"the {name} side ran past "
                                 f"{RUN_TIMEOUT_S} s")
        assert proc.returncode == 0, f"{name}: {out}\n{err}"
    reports = {size: [json.load(open(os.path.join(
        out_dir, f"rank{r}_{size}.json"))) for r in range(size)]
        for size in (WORLD, 1)}
    return out_dir, single, reports


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _leaves_of(arrays):
    return [arrays[f"leaf_{i}"] for i in range(sum(
        1 for k in arrays if k.startswith("leaf_")))]


def _close(got, want, what):
    """STEP on float32 leaves, the bf16 rule on int16 (bfloat16 bits)
    leaves, equality on integer ones."""
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape, (what, i)
        if a.dtype == np.int16:
            a64 = torch.from_numpy(a).view(torch.bfloat16).double().numpy()
            w64 = torch.from_numpy(w).view(torch.bfloat16).double().numpy()
            bound = 2.0 ** -6 * np.abs(w64) + 2.0 ** -9 * np.abs(w64).max()
            assert (np.abs(a64 - w64) <= bound).all(), (what, i)
        elif np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, w, err_msg=f"{what} {i}")
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       w.astype(np.float64),
                                       err_msg=f"{what} leaf {i}", **STEP)


def _hold_metrics(got, want, case):
    gn = 2.0 ** -6 if case != "tinyllama" else 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=gn)


@pytest.mark.parametrize("case", ["tinyllama", "moonshot_noaux"])
def test_sharded_equals_single_process_port(runs, case):
    out_dir, single, reports = runs
    from repro_torch.models.params import tree_leaves
    state, metrics = single[case]
    got = _leaves_of(_load(os.path.join(out_dir, f"port_{WORLD}_{case}"
                                        ".npz")))
    _close(got, [_np(x) for x in tree_leaves(state)], case)
    for rep in reports[WORLD]:
        _hold_metrics(rep[case]["metrics"], metrics, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_reference(runs, case):
    out_dir, _, reports = runs
    want = _load(os.path.join(out_dir, f"jax_{case}.npz"))
    got = _leaves_of(_load(os.path.join(out_dir, f"port_{WORLD}_{case}"
                                        ".npz")))
    _close(got, _leaves_of(want), case)
    ref = [{k: float(want[f"{i}/{k}"]) for k in ("loss", "grad_norm", "lr")}
           for i in range(STEPS)]
    for rep in reports[WORLD]:
        _hold_metrics(rep[case]["metrics"], ref, case)


@pytest.mark.parametrize("case", BITWISE)
def test_mesh_1x1_bitwise(runs, case):
    out_dir, _, reports = runs
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import checkpoint as TCk
    model, state = _model_and_state(case)
    state = TCk.restore(os.path.join(out_dir, f"ckpt_{case}"), state)
    step = _step_fn(model, case)
    metrics = []
    for b in _batches(case):
        state, m = step(state, b)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "lr")})
    got = _leaves_of(_load(os.path.join(out_dir, f"port_1_{case}.npz")))
    want = [_np(x) for x in tree_leaves(state)]
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert reports[1][0][case]["metrics"] == metrics


def test_resume_on_mesh_restores_shards_exactly(runs):
    _, _, reports = runs
    for size, reps in reports.items():
        for rep in reps:
            assert all(r["resume_exact"] for r in rep.values()), size


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        torch.multiprocessing.spawn(_rank_main, nprocs=WORLD, join=True,
                                    args=(WORLD, sys.argv[2]))
