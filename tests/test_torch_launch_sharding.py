"""The port's meshes, sharding rules, dry-run cells and shape trees
(``repro_torch.launch.{mesh,sharding,cells,dryrun}``, meta-device
construction) held against the JAX package.

The file is also the script of the reference's side: ``python <file>
<out>`` under ``XLA_FLAGS=--xla_force_host_platform_device_count=512``
builds every reference cell (``launch.cells.build_cell``) on both
production meshes, without lowering, and writes for each cell its skip
status, its ``meta``, and every argument leaf's shape, dtype,
``NamedSharding.spec`` after ``sharding._shard_ok`` and the bytes of its
shard (``sharding.shard_shape``); and for every config the shapes and
dtypes of ``jax.eval_shape`` of its ``init_params`` and of ``init_state``
with its optimizer.  Leaves are named by their key paths, written as the
reference's ``_path_str`` writes them, after the argument's index.
Everything here is exact: specs, shapes, dtypes, ``meta`` and bytes are
compared for equality.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import FAMILY_SHAPES
from repro_torch.core._threefry import seed_key
from repro_torch.launch import cells as C
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models.params import params_tree
from repro_torch.train.loop import init_state

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 300
MESH_KINDS = ("pod", "multipod")
CELLS = [(a, s) for a in ARCH_IDS
         for s in FAMILY_SHAPES[get_config(a)[2]]]


def _spec(spec, ndim):
    """A spec as JSON: one entry per dimension (None, a name, a list)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ------------------------------------------------------- the reference side
def _jax_name(path) -> str:
    import jax
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.GetAttrKey):
            out.append(f".{k.name}")
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(str(k.idx))
        else:
            out.append(str(k.key))
    return "/".join(out)


def _jax_leaves(tree):
    import jax
    return [(_jax_name(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_main(out_path):
    import jax
    from repro.configs import get_config as jget
    from repro.launch import sharding as JSH
    from repro.launch.cells import SkipCell, _gnn_module, build_cell
    from repro.launch.mesh import make_production_mesh
    from repro.models.recsys import mind as jmind
    from repro.models.transformer import model as JM
    from repro.train.loop import init_state as jinit_state

    assert len(jax.devices()) == 512
    out = {"cells": {}, "trees": {}}
    for kind in MESH_KINDS:
        mesh = make_production_mesh(multi_pod=kind == "multipod")
        for arch, shape in CELLS:
            key = f"{arch}/{shape}/{kind}"
            try:
                cell = build_cell(arch, shape, mesh)
            except SkipCell:
                out["cells"][key] = {"status": "skipped"}
                continue
            leaves = {}
            for i, arg in enumerate(cell.args):
                for name, x in _jax_leaves(arg):
                    spec = JSH._shard_ok(x.sharding.spec, x.shape, mesh)
                    local = x.sharding.shard_shape(x.shape)
                    leaves[f"{i}/{name}" if name else str(i)] = [
                        list(x.shape), str(x.dtype), _spec(spec, x.ndim),
                        int(np.prod(local)) * x.dtype.itemsize]
            out["cells"][key] = {"status": "ok", "meta": cell.meta,
                                 "leaves": leaves}
    rng = jax.random.PRNGKey(0)
    for arch in ARCH_IDS:
        cfg, _, family = jget(arch)
        if family == "lm":
            def init(r, cfg=cfg):
                return JM.init_params(r, cfg)
            opt = cfg.optimizer
        elif family == "recsys":
            def init(r, cfg=cfg):
                return jmind.init_params(r, cfg)
            opt = "adamw"
        else:
            def init(r, cfg=cfg):
                return _gnn_module(cfg.family).init_params(
                    r, cfg, d_feat=cfg.d_feat)
            opt = "adamw"
        state = jax.eval_shape(lambda r: jinit_state(r, init(r), opt), rng)
        out["trees"][arch] = {name: [list(x.shape), str(x.dtype)]
                              for name, x in _jax_leaves(state)}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ref():
    out = os.path.join(tempfile.mkdtemp(prefix="launch_ref_"), "ref.json")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    proc = subprocess.run([sys.executable, __file__, out], env=env,
                          capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with open(out) as f:
        return json.load(f)


# --------------------------------------------------------------- the port
def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _port_leaves(cell):
    return {name: [list(SH._shape(x)), _dtype(x),
                   _spec(lay.spec, len(SH._shape(x))), C.leaf_bytes(x, lay)]
            for name, x, lay in C.cell_leaves(cell)}


@pytest.mark.parametrize("kind", MESH_KINDS)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_equals_reference(ref, arch, shape, kind):
    """Every leaf's shape, dtype, spec and shard bytes, the ``meta`` and
    ``SkipCell``."""
    want = ref["cells"][f"{arch}/{shape}/{kind}"]
    mesh = M.make_production_mesh(multi_pod=kind == "multipod")
    if want["status"] == "skipped":
        with pytest.raises(C.SkipCell):
            C.build_cell(arch, shape, mesh)
        return
    cell = C.build_cell(arch, shape, mesh)
    got = _port_leaves(cell)
    assert sorted(got) == sorted(want["leaves"])
    for name, w in want["leaves"].items():
        assert got[name] == w, name
    assert json.loads(json.dumps(cell.meta)) == want["meta"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_tree_equals_eval_shape(ref, arch):
    """The parameters (built on the meta device; a GNN on the host) and
    the optimizer state of every config against ``jax.eval_shape`` of
    the reference's ``init_params`` and ``init_state``."""
    cfg, _, family = get_config(arch)
    if family == "lm":
        from repro_torch.models.transformer.model import Transformer
        model = Transformer(cfg, device="meta")
        params, opt = model.params, cfg.optimizer
        assert all(p.is_meta for p in model.parameters())
    elif family == "recsys":
        from repro_torch.models.recsys.mind import MIND
        params, opt = params_tree(MIND(cfg, device="meta")), "adamw"
    else:
        params = params_tree(C._gnn_class(cfg.family)(cfg, cfg.d_feat))
        opt = "adamw"
    state = init_state(seed_key(0), params, opt)
    got = {}
    SH.tree_map_with_path(lambda p, x: got.__setitem__(
        p, [list(SH._shape(x)), _dtype(x)]), state)
    assert got == ref["trees"][arch]


def test_dryrun_cli_all(tmp_path, ref):
    """``--all`` exits 0 and writes one record a cell and mesh, whose
    argument bytes are the reference cell's shard bytes."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "72 ok, 8 skipped"
    for kind in MESH_KINDS:
        for arch, shape in CELLS:
            with open(tmp_path / f"{arch}__{shape}__{kind}.json") as f:
                rec = json.load(f)
            want = ref["cells"][f"{arch}/{shape}/{kind}"]
            assert rec["status"] == want["status"]
            assert rec["n_devices"] == (512 if kind == "multipod" else 256)
            if want["status"] == "ok":
                mem = rec["memory"]
                assert mem["argument_bytes"] == sum(
                    w[3] for w in want["leaves"].values())
                assert mem["peak_bytes_per_device"] == mem["argument_bytes"]
                assert mem["fits"] == (mem["argument_bytes"]
                                       <= 80 * 2 ** 30)
                assert rec["meta"] == want["meta"]


def test_dryrun_cli_accepts_save_hlo(tmp_path, ref):
    """``--save-hlo DIR``, which the reference's command line takes, exits
    0, writes the cell's record as without it, and writes no HLO."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}"}
    hlo = tmp_path / "hlo"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k", "--save-hlo", str(hlo),
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(tmp_path / "tinyllama-1.1b__train_4k__pod.json") as f:
        rec = json.load(f)
    want = ref["cells"]["tinyllama-1.1b/train_4k/pod"]
    assert rec["status"] == want["status"] == "ok"
    assert rec["memory"]["argument_bytes"] == sum(
        w[3] for w in want["leaves"].values())
    assert not hlo.exists() or not any(hlo.iterdir())


def test_production_mesh_and_constants():
    pod, multi = M.make_production_mesh(), \
        M.make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.shape, pod.abstract) == (
        ("data", "model"), (16, 16), True)
    assert (multi.axis_names, multi.shape) == (("pod", "data", "model"),
                                               (2, 16, 16))
    assert M.mesh_axes(multi) == {"dp": ("pod", "data"), "model": "model",
                                  "all": ("pod", "data", "model")}
    with pytest.raises(ValueError):
        pod.get_group("data")
    # one NVIDIA H100 80GB HBM3, not the reference's TPU v5e
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.ICI_BW, M.CHIP_HBM_BYTES) == (
        989e12, 3.35e12, 4.5e11, 80 * 2 ** 30)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_mesh_compat((1, 1), ("data", "model"), device="cpu")


def test_layout_shards_and_local_shapes():
    """A live-mesh layout's blocks, on a mesh of one rank and on
    coordinates of a larger one (no collective runs)."""
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    for coords in [(0, 0), (1, 0), (0, 1), (1, 1)]:
        mesh = M.Mesh(("data", "model"), (2, 2), coords,
                      torch.device("cpu"))
        lay = SH.Layout(mesh, SH.P(None, "data", "model"))
        assert lay.local_shape(x.shape) == (4, 3, 4)
        i, j = coords
        assert torch.equal(lay.shard(x), x[:, 3 * i:3 * i + 3,
                                           4 * j:4 * j + 4])
        both = SH.Layout(mesh, SH.P(("data", "model")))
        assert torch.equal(both.shard(x), x[2 * i + j:2 * i + j + 1])
        assert lay.split_axes() == ("data", "model")
    assert SH.P(("data",), None) == ("data", None)
    with pytest.raises(ValueError):
        SH.Layout(mesh, SH.P("data")).local_shape((3,))


if __name__ == "__main__":
    _jax_main(sys.argv[1])
