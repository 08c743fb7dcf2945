"""The port's ``configs/`` and GNN family (PNA, NequIP, MACE, DimeNet) and
the twin of ``examples/gnn_reachability.py``, held against the JAX package
on seeded inputs.

The JAX ``init_params`` trees are carried into the port's modules by
``load_numpy_params`` and the gradients back out by ``grads_to_numpy``, so
parity never depends on the two packages' random streams.  Everything is
float32 and sums in another order than XLA does; tolerances: forward
outputs, energies and losses rtol 1e-5, atol 1e-5; parameter gradients and
forces rtol 1e-4, atol 1e-5; with bfloat16 messages rtol 1e-2 (and the
atol of the measured rounding gap, see ``test_model_equals_reference``).
The numpy halves (Clebsch-Gordan, Wigner-D, rotations, triplets) and the
configs are compared exactly."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs import dimenet as jcfg_dimenet
from repro.configs import mace as jcfg_mace
from repro.configs import nequip as jcfg_nequip
from repro.configs import pna as jcfg_pna
from repro.configs import shapes as JShapes
from repro.models.gnn import common as JCommon
from repro.models.gnn import dimenet as JDimeNet
from repro.models.gnn import irreps as JIrreps
from repro.models.gnn import mace as JMACE
from repro.models.gnn import nequip as JNequIP
from repro.models.gnn import pna as JPNA
from repro_torch import configs as TC
from repro_torch.configs import shapes as TShapes
from repro_torch.models.gnn import common as TCommon
from repro_torch.models.gnn import irreps as TIrreps
from repro_torch.models.gnn.common import (flatten_tree, grads_to_numpy,
                                           load_numpy_params, sgd_step)
from repro_torch.models.gnn.dimenet import DimeNet
from repro_torch.models.gnn.mace import MACE
from repro_torch.models.gnn.nequip import NequIP
from repro_torch.models.gnn.pna import PNA

ROOT = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
#: bfloat16 messages: rtol 1e-2, with the atol the measured rounding gap
#: needs (``test_model_equals_reference``)
BF16_FWD = dict(rtol=1e-2, atol=2e-2)
BF16_GRAD = dict(rtol=1e-2, atol=5e-3)

MODELS = {
    "pna": (JPNA, PNA, jcfg_pna.SMOKE),
    "nequip": (JNequIP, NequIP, jcfg_nequip.SMOKE),
    "mace": (JMACE, MACE, jcfg_mace.SMOKE),
    "dimenet": (JDimeNet, DimeNet, jcfg_dimenet.SMOKE),
}
#: (case id, model, config changes): every model at SMOKE, PNA's fused
#: statistics and bf16 messages, DimeNet's projection before the gather
CASES = [
    ("pna", "pna", {}),
    ("pna-fused", "pna", dict(fused_stats=True)),
    ("pna-bf16", "pna", dict(msg_dtype="bfloat16")),
    ("pna-fused-bf16", "pna", dict(fused_stats=True, msg_dtype="bfloat16")),
    ("nequip", "nequip", {}),
    ("mace", "mace", {}),
    ("dimenet", "dimenet", {}),
    ("dimenet-proj", "dimenet", dict(trip_proj_dim=4)),
]


def make_batch(rng, n=20, m=60, d_feat=12, n_classes=16, with_geom=True,
               max_triplets=200, self_loop=None):
    """The reference tests' batch as numpy: random edges, the last three
    invalid; ``self_loop`` puts edge 0 at (v, v)."""
    ei = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)]
                  ).astype(np.int32)
    if self_loop is not None:
        ei[:, 0] = self_loop
    valid = np.ones(m, bool)
    valid[-3:] = False
    batch = {
        "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32)
        if d_feat else None,
        "edge_index": ei,
        "edge_valid": valid,
        "species": rng.integers(0, 8, n).astype(np.int32),
        "labels": rng.integers(0, n_classes, n).astype(np.int32),
    }
    if with_geom:
        batch["positions"] = rng.normal(scale=1.5, size=(n, 3)).astype(
            np.float32)
        t_in, t_out, t_val = JCommon.build_triplets(ei, valid, max_triplets)
        batch.update(triplet_in=t_in, triplet_out=t_out, triplet_valid=t_val)
    return batch


def to_jax(batch):
    return {k: v if v is None or np.isscalar(v) else jnp.asarray(v)
            for k, v in batch.items()}


def to_torch(batch):
    return {k: v if v is None or np.isscalar(v) else torch.as_tensor(v)
            for k, v in batch.items()}


def carried(jmod, tcls, cfg, d_feat, key=0):
    """(reference params, the port's module holding the same values)."""
    params = jmod.init_params(jax.random.PRNGKey(key), cfg, d_feat=d_feat)
    module = tcls(cfg, d_feat)
    load_numpy_params(module, jax.tree.map(np.asarray, params))
    return params, module


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_equals_reference(arch):
    want = JC.get_config(arch)
    got = TC.get_config(arch)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        if hasattr(w, "params_dense"):
            assert (g.params_dense, g.params_active) == \
                (w.params_dense, w.params_active)


def test_shape_tables_equal_reference():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    for fam, table in JShapes.FAMILY_SHAPES.items():
        got = TShapes.FAMILY_SHAPES[fam]
        assert list(got) == list(table)
        for name, shape in table.items():
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(shape)
    assert TShapes.LONG_CONTEXT_OK == JShapes.LONG_CONTEXT_OK


# ------------------------------------------------------------- numpy halves
def test_clebsch_gordan_and_wigner_d_equal_reference():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                np.testing.assert_array_equal(
                    TIrreps.clebsch_gordan(l1, l2, l3),
                    JIrreps.clebsch_gordan(l1, l2, l3))
    R = TIrreps.random_rotation(np.random.default_rng(5))
    np.testing.assert_array_equal(
        R, JIrreps.random_rotation(np.random.default_rng(5)))
    for l in range(3):
        np.testing.assert_array_equal(TIrreps.wigner_d(l, R),
                                      JIrreps.wigner_d(l, R))


@pytest.mark.parametrize("max_triplets", [200, 17])
def test_build_triplets_equals_reference(max_triplets):
    """Padded (200) and cut short (17) triplet lists are the reference's."""
    b = make_batch(np.random.default_rng(2), with_geom=False)
    got = TCommon.build_triplets(b["edge_index"], b["edge_valid"],
                                 max_triplets)
    want = JCommon.build_triplets(b["edge_index"], b["edge_valid"],
                                  max_triplets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_geometry_bases_equal_reference():
    rng = np.random.default_rng(4)
    vec = rng.normal(size=(50, 3)).astype(np.float32)
    vec[0] = 0.0                                  # a zero-length edge
    r = np.linalg.norm(vec, axis=-1).astype(np.float32)
    got = TIrreps.spherical_harmonics(torch.as_tensor(vec), 2)
    want = JIrreps.spherical_harmonics(jnp.asarray(vec), 2)
    for l in range(3):
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]), **FWD)
    np.testing.assert_allclose(
        TIrreps.bessel_basis(torch.as_tensor(r), 8, 5.0).numpy(),
        np.asarray(JIrreps.bessel_basis(jnp.asarray(r), 8, 5.0)), **FWD)
    cos = np.clip(rng.normal(size=40), -1, 1).astype(np.float32)
    np.testing.assert_allclose(
        TCommon.legendre(torch.as_tensor(cos), 7).numpy(),
        np.asarray(JCommon.legendre(jnp.asarray(cos), 7)), **FWD)


def test_aggregates_empty_segments_and_masked_edges():
    """An isolated node's mean, max and min are 0 (not -inf) and its std
    sqrt(1e-5), a masked edge gets no gradient, and both equal the
    reference's ``multi_aggregate``."""
    rng = np.random.default_rng(6)
    n, m = 6, 14
    ei = np.stack([rng.integers(0, n, m),
                   rng.integers(0, n - 1, m)]).astype(np.int32)  # n-1 empty
    valid = np.ones(m, bool)
    valid[[2, 7]] = False
    ei[1, 7] = 0                                  # a masked edge into 0
    msg = rng.normal(size=(m, 4)).astype(np.float32)
    want = JCommon.multi_aggregate(jnp.asarray(msg), jnp.asarray(ei),
                                   jnp.asarray(valid), n)
    tmsg = torch.as_tensor(msg).requires_grad_(True)
    got = TCommon.multi_aggregate(tmsg, torch.as_tensor(ei),
                                  torch.as_tensor(valid), n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FWD)
    for g in got[:3]:
        assert (g[n - 1] == 0).all() and torch.isfinite(g).all()
    assert torch.allclose(got[3][n - 1], torch.tensor(1e-5).sqrt())
    sum(g.sum() for g in got[:4]).backward()
    assert (tmsg.grad[[2, 7]] == 0).all()
    jgrad = jax.grad(lambda x: sum(a.sum() for a in JCommon.multi_aggregate(
        x, jnp.asarray(ei), jnp.asarray(valid), n)[:4]))(jnp.asarray(msg))
    np.testing.assert_allclose(tmsg.grad.numpy(), np.asarray(jgrad), **GRAD)


def test_load_numpy_params_checks_names_and_shapes():
    params, module = carried(JPNA, PNA, jcfg_pna.SMOKE, 12)
    tree = jax.tree.map(np.asarray, params)
    assert set(flatten_tree(tree)) == set(dict(module.named_parameters()))
    del tree["layers"][1]["upd"]["b1"]
    with pytest.raises(KeyError, match="layers.1.upd.b1"):
        load_numpy_params(module, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["layers"][0]["upd"]["w0"] = tree["layers"][0]["upd"]["w0"].T
    with pytest.raises(ValueError, match="layers.0.upd.w0"):
        load_numpy_params(module, tree)


# ------------------------------------------------------ models vs reference
def reference_outputs(jmod, cfg, params, jb, forces):
    """The reference's forward, energy, loss, gradients (and forces) in one
    jitted call, as numpy."""
    def run(p, b):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jmod.loss_fn(q, cfg, b), has_aux=True)(p)
        out = dict(apply=jmod.apply(p, cfg, b),
                   node_logits=jmod.node_logits(p, cfg, b),
                   energy=jmod.energy(p, cfg, b), loss=loss, grads=grads)
        if forces:
            out["forces"] = jmod.forces(p, cfg, b)
        return out
    return jax.tree.map(np.asarray, jax.jit(run)(params, jb))


@pytest.mark.parametrize("case,name,changes", CASES,
                         ids=[c[0] for c in CASES])
def test_model_equals_reference(case, name, changes):
    """Forward (``apply`` and ``node_logits``), energy, loss, every
    parameter's gradient of the loss, and (geometric models) forces, on
    ``make_batch`` with a self-loop at vertex 5.

    With bfloat16 messages the reference's segment sums round to bf16
    after every add (XLA on the CPU), the port's sum in float32 and round
    once; the outputs then differ by up to 8.1e-3 beyond rtol 1e-2 (atol
    2e-2 here) and the gradients by up to 2.3e-3 (atol 5e-3).  With fused
    statistics in bf16 the std's cancellation turns that rounding into
    the gradient itself (the reference's own bf16 gradient is 24-69 %
    off its float32 one, norm-wise), so only the forward and the loss
    are compared there."""
    jmod, tcls, cfg = MODELS[name]
    cfg = cfg.scaled(**changes)
    bf16 = cfg.msg_dtype == "bfloat16"
    fwd = BF16_FWD if bf16 else FWD
    nb = make_batch(np.random.default_rng(0), n_classes=cfg.n_classes,
                    self_loop=5)
    tb = to_torch(nb)
    params, module = carried(jmod, tcls, cfg, 12)
    want = reference_outputs(jmod, cfg, params, to_jax(nb),
                             forces=name != "pna")

    for key in ("apply", "node_logits", "energy"):
        np.testing.assert_allclose(getattr(module, key)(tb).detach().numpy(),
                                   want[key], err_msg=key, **fwd)
    tloss, _ = module.loss_fn(tb)
    np.testing.assert_allclose(float(tloss.detach()), want["loss"], **fwd)
    tloss.backward()
    got = grads_to_numpy(module)
    want_g = flatten_tree(want["grads"])
    assert set(got) == set(want_g)
    if not (bf16 and cfg.fused_stats):
        for k in want_g:
            np.testing.assert_allclose(got[k], want_g[k], err_msg=k,
                                       **(BF16_GRAD if bf16 else GRAD))
    assert all(np.isfinite(g).all() for g in got.values())
    if "forces" in want:
        got_f = module.forces(tb).numpy()
        np.testing.assert_array_equal(np.isnan(got_f),
                                      np.isnan(want["forces"]))
        assert np.isnan(got_f[5]).all()
        np.testing.assert_allclose(got_f, want["forces"], **GRAD)


def test_energy_target_loss_equals_reference():
    """The regression branch of every loss (graph ids, per-graph energy
    targets) and PNA's masked cross-entropy."""
    for name, (jmod, tcls, cfg) in MODELS.items():
        nb = make_batch(np.random.default_rng(3), d_feat=0)
        nb.update(graph_ids=np.repeat(np.arange(4, dtype=np.int32), 5),
                  n_graphs=4,
                  energy_target=np.linspace(-1, 1, 4).astype(np.float32))
        params, module = carried(jmod, tcls, cfg, 0)
        jloss = jax.jit(lambda p, b: jmod.loss_fn(
            p, cfg, {**b, "n_graphs": 4})[0])(
            params, to_jax({k: v for k, v in nb.items() if k != "n_graphs"}))
        np.testing.assert_allclose(
            float(module.loss_fn(to_torch(nb))[0].detach()), float(jloss),
            err_msg=name, **FWD)
    nb = make_batch(np.random.default_rng(3), with_geom=False)
    nb["label_mask"] = np.arange(20) % 3 == 0
    params, module = carried(JPNA, PNA, jcfg_pna.SMOKE, 12)
    np.testing.assert_allclose(
        float(module.loss_fn(to_torch(nb))[0].detach()),
        float(JPNA.loss_fn(params, jcfg_pna.SMOKE, to_jax(nb))[0]), **FWD)


@pytest.mark.parametrize("name", ["nequip", "mace"])
def test_self_loop_forces_nan_pattern_equals_reference(name):
    """A zero-length edge gives NaN forces on its vertex in the reference
    (``jnp.linalg.norm``'s gradient at 0); the port gives the same rows
    NaN and equal forces elsewhere."""
    jmod, tcls, cfg = MODELS[name]
    nb = make_batch(np.random.default_rng(1), n=12, m=40, d_feat=0)
    nb["edge_index"][:, nb["edge_index"][0] == nb["edge_index"][1]] = \
        np.array([[0], [1]])                      # no other self-loop
    nb["edge_index"][:, 3] = 7
    params, module = carried(jmod, tcls, cfg, 0, key=1)
    want = np.asarray(jax.jit(lambda p, b: jmod.forces(p, cfg, b))(
        params, to_jax(nb)))
    got = module.forces(to_torch(nb)).numpy()
    nan_rows = np.flatnonzero(np.isnan(want).any(-1))
    assert nan_rows.tolist() == [7]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **GRAD)


# ---------------------------------------- the reference's model tests, twins
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_train_step(name):
    _, tcls, cfg = MODELS[name]
    torch.manual_seed(0)
    tb = to_torch(make_batch(np.random.default_rng(0),
                             n_classes=cfg.n_classes))
    module = tcls(cfg, 12)
    losses = []
    for _ in range(5):
        loss, _ = module.loss_fn(tb)
        loss.backward()
        sgd_step(module, 0.1)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", ["nequip", "mace"])
def test_energy_invariance_forces_equivariance(name):
    _, tcls, cfg = MODELS[name]
    rng = np.random.default_rng(1)
    nb = make_batch(rng, n=12, m=40, d_feat=0)
    module = tcls(cfg, 0, seed=1)
    e0, f0 = TCommon.energy_forces(module, to_torch(nb))
    R = TIrreps.random_rotation(rng)
    nb_r = {**nb, "positions": (nb["positions"] @ R.T).astype(np.float32)}
    e1, f1 = TCommon.energy_forces(module, to_torch(nb_r))
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(f1.numpy(), f0.numpy() @ R.T, rtol=2e-3,
                               atol=2e-4)


def test_dimenet_rotation_invariance():
    _, tcls, cfg = MODELS["dimenet"]
    rng = np.random.default_rng(2)
    nb = make_batch(rng, n=12, m=40, d_feat=0)
    module = tcls(cfg, 0, seed=2)
    e0 = module.energy(to_torch(nb)).detach().numpy()
    R = TIrreps.random_rotation(rng)
    nb_r = {**nb, "positions": (nb["positions"] @ R.T).astype(np.float32)}
    e1 = module.energy(to_torch(nb_r)).detach().numpy()
    np.testing.assert_allclose(e1, e0, rtol=1e-5, atol=1e-6)


def test_pna_degree_scalers_affect_output():
    _, tcls, cfg = MODELS["pna"]
    nb = make_batch(np.random.default_rng(3), with_geom=False)
    module = tcls(cfg, 12, seed=3)
    h = module.apply(to_torch(nb)).detach().numpy()
    assert np.isfinite(h).all()
    # knock out half the edges; degree-scaled aggregates must change
    ev = nb["edge_valid"].copy()
    ev[::2] = False
    h2 = module.apply(to_torch({**nb, "edge_valid": ev})).detach().numpy()
    assert not np.allclose(h, h2)


# ------------------------------------------------------------- example twin
def _reference_loop(rounds):
    """``examples/gnn_reachability.py``'s loop through the JAX package,
    returning [(kept, total, loss)] and the initial parameters."""
    from repro.core import DBLIndex, make_graph
    from repro.graphs.generators import power_law
    from repro.graphs.sampler import CSR, reachability_filtered_sample
    n, m = 3_000, 18_000
    src, dst = power_law(n, m, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 8, n).astype(np.int32)
    idx = DBLIndex.build(make_graph(src, dst, n, m_cap=m + 500), n_cap=n,
                         k=32, k_prime=32, max_iters=64)
    csr = CSR.from_edges(n, src, dst)
    targets = np.argsort(-np.bincount(dst, minlength=n))[:4].astype(np.int32)
    cfg = jcfg_pna.SMOKE.scaled(n_classes=8)
    params = JPNA.init_params(jax.random.PRNGKey(0), cfg, d_feat=16)
    p0 = jax.tree.map(np.asarray, params)

    @jax.jit
    def step(p, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: JPNA.loss_fn(p, cfg, batch), has_aux=True)(p)
        return jax.tree.map(lambda w, g_: w - 0.05 * g_, p, grads), loss

    out = []
    for _ in range(rounds):
        seeds = rng.choice(n, 32, replace=False)
        sub = reachability_filtered_sample(csr, seeds, [5, 3], idx, targets,
                                           rng=rng)
        blocks = sub.blocks
        batch = {
            "node_feat": jnp.asarray(feats[sub.nodes]),
            "edge_index": jnp.asarray(np.stack([
                np.concatenate([b.src for b in blocks]),
                np.concatenate([b.dst for b in blocks])])),
            "edge_valid": jnp.asarray(np.concatenate(
                [b.edge_valid for b in blocks])),
            "species": jnp.zeros(len(sub.nodes), jnp.int32),
            "labels": jnp.asarray(labels[sub.nodes]),
        }
        params, loss = step(params, batch)
        idx = idx.insert_edges(rng.integers(0, n, 20).astype(np.int32),
                               rng.integers(0, n, 20).astype(np.int32),
                               max_iters=64)
        out.append((sum(int(b.edge_valid.sum()) for b in blocks),
                    sum(len(b.edge_valid) for b in blocks), float(loss)))
    return out, p0


def _twin():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import gnn_reachability_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return gnn_reachability_torch


def test_gnn_twin_equals_reference_loop():
    """From the reference's initial parameters the twin keeps the same
    edges of the same samples every round and takes the same losses."""
    rounds = 3
    want, p0 = _reference_loop(rounds)
    got = _twin().run(device="cpu", params=p0, rounds=rounds)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert any(0 < k < t for k, t, _ in want)
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-4)


def _run_example(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def test_example_twin_runs_on_the_cpu():
    out = _run_example("examples/gnn_reachability_torch.py", "--device",
                       "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.rstrip().endswith("OK"), out.stdout[-2000:]


def test_example_twin_asks_for_cuda_by_default():
    """Without ``--device`` the twin runs on CUDA; where there is none it
    fails and names the CPU opt-in rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = _run_example("examples/gnn_reachability_torch.py")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert "OK" not in out.stdout
