"""The port's expert-parallel MoE (``models.transformer.moe_sharded``)
held against the JAX package's ``moe_ffn_sharded`` and ``moe_ffn``, and
the ``"moe_call"`` hook of ``launch.cells.lm_constrain`` through a
Transformer forward.

The file is also the script that runs both sides.  ``python <file> jax
<out>`` runs the reference under ``XLA_FLAGS=
--xla_force_host_platform_device_count=8`` on mesh (4, 2) (and (2, 2) on
four of the devices); ``python <file> torch <out>`` spawns 8 gloo ranks
(``torch.multiprocessing``, a ``FileStore``, a 120 s group timeout) on
mesh (4, 2), then 4 of them on mesh (2, 2).  Rank (i, j) holds token
block ``2 i + j`` (``in_specs=P(all_axes, None)``) and experts block j.
Both read the same numpy-seeded inputs (E 8, top-2, d 16, d_ff 32,
T 256, as ``tests/distributed/run_moe_sharded.py``).  pytest starts both
at once and compares.

Tolerances (the reference test's): ``y`` rtol 2e-4, atol 2e-5 against
both JAX functions in the no-drop regime (capacity factor 64,
``router_aux_weight=0``); ``aux`` (weight 0.01) rtol 1e-5 against the
sharded reference, whose per-rank estimator the port computes, and the
reference's loose rtol 8e-2 against ``moe_ffn``; the gradients of
``w1``, ``w2``, ``w3`` and ``router`` of ``mean(y^2) + aux`` rtol 5e-3,
atol 1e-5.  Each rank's loss is its share of that loss (its block's sum
of ``y^2`` over T d, plus ``aux / 8``), and a gradient is the sum over
the ranks.  The drop regime (capacity factor 1) on mesh (2, 2): ``y``
and ``aux`` against the sharded reference at the same tolerances.
"""
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
E, K, D, F, T = 8, 2, 16, 32, 256
MESHES = {"4x2": (4, 2), "2x2": (2, 2)}
GROUP_TIMEOUT_S = 120
RUN_TIMEOUT_S = 300
Y_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
GRAD_KEYS = ("w1", "w2", "w3", "router")
#: no drops with aux weight 0, no drops with the default aux weight, and
#: the drop regime (capacity factor 1)
CASES = {"nodrop": dict(capacity_factor=64.0, router_aux_weight=0.0),
         "aux": dict(capacity_factor=64.0),
         "drop": dict(capacity_factor=1.0)}


def _inputs():
    rng = np.random.default_rng(23)

    def nrm(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    params = {"router": nrm((D, E), D ** -0.5), "w1": nrm((E, D, F),
                                                          D ** -0.5),
              "w3": nrm((E, D, F), D ** -0.5), "w2": nrm((E, F, D),
                                                          F ** -0.5)}
    return params, nrm((T, D), 1.0)


def _blocks(mesh_shape):
    return int(np.prod(mesh_shape))


# ------------------------------------------------------------- the JAX side
def _jax_main(out_dir):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig
    from repro.launch.mesh import make_mesh_compat
    from repro.models.transformer.model import _act
    from repro.models.transformer.moe import moe_ffn
    from repro.models.transformer.moe_sharded import moe_ffn_sharded

    assert len(jax.devices()) == 8
    p_np, x_np = _inputs()
    params = {k: jnp.asarray(v) for k, v in p_np.items()}
    x = jnp.asarray(x_np)
    act = _act("silu")
    out = {}
    for mesh_name, shape in MESHES.items():
        mesh = make_mesh_compat(shape, ("data", "model"),
                                devices=jax.devices()[:_blocks(shape)])
        cases = ("drop",) if mesh_name == "2x2" else ("nodrop", "aux")
        for case in cases:
            cfg = MoEConfig(n_experts=E, top_k=K, d_ff=F, **CASES[case])

            def sharded(p, x, cfg=cfg, mesh=mesh):
                with mesh:
                    return moe_ffn_sharded(p, x, cfg, act, mesh=mesh,
                                           dp_axes=("data",),
                                           tp_axis="model")

            def local(p, x, cfg=cfg):
                return moe_ffn(p, x, cfg, act)

            for name, fn in (("sharded", sharded), ("ffn", local)):
                y, aux = jax.jit(fn)(params, x)
                out[f"{mesh_name}/{case}/{name}/y"] = np.asarray(y)
                out[f"{mesh_name}/{case}/{name}/aux"] = np.asarray(aux)
                if case == "drop":
                    continue

                def loss(p, fn=fn):
                    y, aux = fn(p, x)
                    return (y * y).mean() + aux
                g = jax.jit(jax.grad(loss))(params)
                for k in GRAD_KEYS:
                    out[f"{mesh_name}/{case}/{name}/g_{k}"] = np.asarray(g[k])
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


# ----------------------------------------------------------- the port side
def _moe_on_rank(mesh, case):
    """(y block, aux, {leaf: this rank's gradient of its loss share})."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.transformer.model import _act
    from repro_torch.models.transformer.moe_sharded import moe_ffn_sharded
    p_np, x_np = _inputs()
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff=F, **CASES[case])
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in p_np.items()}
    n = mesh.size
    i, j = mesh.coords
    blk = T // n
    c = i * mesh.sizes["model"] + j
    x = torch.tensor(x_np[c * blk:(c + 1) * blk])
    y, aux = moe_ffn_sharded(params, x, cfg, _act("silu"), mesh=mesh,
                             dp_axes=("data",), tp_axis="model")
    share = (y * y).sum() / (T * D) + aux / n
    grads = torch.autograd.grad(share, [params[k] for k in GRAD_KEYS])
    return (y.detach().numpy(), float(aux),
            {k: g.numpy() for k, g in zip(GRAD_KEYS, grads)})


def _hook_on_rank(mesh):
    """The hooked and unhooked logits of a SMOKE moonshot on this rank's
    data block (the same weights on every rank)."""
    from repro_torch.configs import moonshot_v1_16b_a3b as TM
    from repro_torch.launch.cells import lm_constrain
    from repro_torch.models.transformer.model import Transformer
    cfg = TM.SMOKE.scaled(moe_impl="shard_map")
    model = Transformer(cfg, seed=5, device="cpu")
    tokens = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (8, 16)), dtype=torch.int32)
    rows = 8 // mesh.sizes["data"]
    blk = tokens[mesh.coord("data") * rows:(mesh.coord("data") + 1) * rows]
    with torch.no_grad():
        hooked, _ = model(blk, constrain=lm_constrain(cfg, mesh))
        plain, _ = model(blk)
    return hooked.numpy(), plain.numpy()


def _rank_main(rank, world, out_dir):
    from repro_torch.launch.mesh import make_mesh_compat
    torch.set_num_threads(1)
    for mesh_name, shape in MESHES.items():
        size = _blocks(shape)
        if rank >= size:
            return
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir,
                                                      f"store_{mesh_name}"),
                                         size),
            rank=rank, world_size=size,
            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
            assert mesh.coords == tuple(np.unravel_index(rank, shape))
            out = {}
            cases = ("drop",) if mesh_name == "2x2" else ("nodrop", "aux")
            for case in cases:
                y, aux, grads = _moe_on_rank(mesh, case)
                out[f"{case}/y"], out[f"{case}/aux"] = y, np.float32(aux)
                for k, g in grads.items():
                    out[f"{case}/g_{k}"] = g
            if mesh_name == "4x2":
                out["hooked"], out["plain"] = _hook_on_rank(mesh)
            np.savez(os.path.join(out_dir, f"{mesh_name}_rank{rank}.npz"),
                     **out)
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------------------- pytest
@pytest.fixture(scope="module")
def runs():
    out_dir = tempfile.mkdtemp(prefix="moe_sharded_")
    base = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}",
            "OMP_NUM_THREADS": "1"}
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, __file__, "jax", out_dir],
            env={**base, "JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                 "--xla_force_host_platform_device_count=8"},
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
    ranks = {m: [dict(np.load(os.path.join(out_dir, f"{m}_rank{r}.npz")))
                 for r in range(_blocks(s))] for m, s in MESHES.items()}
    return dict(np.load(os.path.join(out_dir, "jax.npz"))), ranks


def _y(ranks, case):
    """The global y: the ranks' blocks in rank order (block 2 i + j)."""
    return np.concatenate([r[f"{case}/y"] for r in ranks])


@pytest.mark.parametrize("against", ["sharded", "ffn"])
def test_y_no_drop_equals_reference(runs, against):
    ref, ranks = runs
    np.testing.assert_allclose(_y(ranks["4x2"], "nodrop"),
                               ref[f"4x2/nodrop/{against}/y"], **Y_TOL)


def test_aux_equals_sharded_reference(runs):
    ref, ranks = runs
    for r in ranks["4x2"]:
        assert float(r["nodrop/aux"]) == 0.0
        np.testing.assert_allclose(float(r["aux/aux"]),
                                   float(ref["4x2/aux/sharded/aux"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r["aux/aux"]),
                                   float(ref["4x2/aux/ffn/aux"]), rtol=8e-2)
    np.testing.assert_allclose(_y(ranks["4x2"], "aux"),
                               ref["4x2/aux/sharded/y"], **Y_TOL)


@pytest.mark.parametrize("case,against", [("nodrop", "sharded"),
                                          ("nodrop", "ffn"),
                                          ("aux", "sharded")])
@pytest.mark.parametrize("leaf", GRAD_KEYS)
def test_grads_equal_reference(runs, case, against, leaf):
    ref, ranks = runs
    got = sum(r[f"{case}/g_{leaf}"].astype(np.float64) for r in ranks["4x2"])
    np.testing.assert_allclose(got, ref[f"4x2/{case}/{against}/g_{leaf}"],
                               **GRAD_TOL)


def test_drop_regime_equals_sharded_reference(runs):
    """Capacity factor 1 drops slots; the per-rank capacity drops the
    same ones on both sides."""
    ref, ranks = runs
    y = _y(ranks["2x2"], "drop")
    assert not np.allclose(y, ref["2x2/drop/ffn/y"], **Y_TOL)  # drops
    np.testing.assert_allclose(y, ref["2x2/drop/sharded/y"], **Y_TOL)
    for r in ranks["2x2"]:
        np.testing.assert_allclose(float(r["drop/aux"]),
                                   float(ref["2x2/drop/sharded/aux"]),
                                   rtol=1e-5)


def test_moe_call_hook_equals_unhooked(runs):
    _, ranks = runs
    for r in ranks["4x2"]:
        assert r["hooked"].shape == (2, 16, 256)
        np.testing.assert_allclose(r["hooked"], r["plain"], **Y_TOL)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        world = max(_blocks(s) for s in MESHES.values())
        torch.multiprocessing.spawn(_rank_main, nprocs=world, join=True,
                                    args=(world, sys.argv[2]))
