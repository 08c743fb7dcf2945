"""The port stands alone: no file of ``repro_torch``, no example twin
(``examples/*_torch.py``) and not ``chip_smoke.py`` imports JAX or the
JAX package, the package imports with both blocked,
and entry points default to CUDA without moving to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_package_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.kernels.bfs_prune.ops import admit_plane
    from repro_torch.kernels.dbl_query.ops import query_verdicts
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import main
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 2], np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_graph(src, dst, 3)
    g = make_graph(src, dst, 3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DBLIndex.build(g, n_cap=3, k=2, k_prime=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--n", "8", "--m", "16"])
    idx = DBLIndex.build(g, n_cap=3, k=2, k_prime=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        query_verdicts(idx.packed, [0], [2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        admit_plane(idx.packed, [0], [2])
    # the engine follows its index; the torch path is refused on CUDA
    eng = QueryEngine(idx)
    assert eng.device.type == "cpu" and eng.backend == "torch"
    assert eng.query([0, 2], [2, 0]).tolist() == [True, False]
    from repro_torch.serve.engine import select_backend
    with pytest.raises(ValueError):
        select_backend("torch", torch.device("cuda"))
    with pytest.raises(ValueError):
        select_backend("cuda", torch.device("cpu"))
    # the training path: data pipelines, a Transformer-backed state, the
    # launcher
    from repro_torch.configs import mind, tinyllama_11b
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train import data
    for batches in (lambda **kw: data.lm_batches(tinyllama_11b.SMOKE, 2, 4,
                                                 **kw),
                    lambda **kw: data.recsys_batches(
                        mind.CONFIG.scaled(n_items=50), 2, **kw),
                    lambda **kw: data.gnn_full_batches(8, 16, 2, 2, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(batches())
        assert next(batches(device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(tinyllama_11b.SMOKE)
    from repro_torch.train.loop import init_state
    model = Transformer(tinyllama_11b.SMOKE, device="cpu")
    state = init_state((0, 1), model.params)
    assert all(t.device.type == "cpu" for t in state.opt_state.m.values()
               if isinstance(t, torch.Tensor))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])


# ------------------------------------------------- public names
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
#: modules of the JAX package with no counterpart, by design
#: (ROADMAP.md §1): the CUDA kernels mask their own ragged edge, and each
#: op wrapper's plain PyTorch version is the kernel's reference
NO_COUNTERPART = {"kernels/_pad.py", "kernels/bfs_prune/ref.py",
                  "kernels/dbl_query/ref.py"}
#: class members with no counterpart, by design: JAX's pytree protocol,
#: and a jit lowering that ``torch.export`` has no counterpart of
NO_MEMBER = {("core/planes.py", "PlaneStore", "tree_flatten"),
             ("core/planes.py", "PlaneStore", "tree_unflatten"),
             ("serve/aot.py", "ShapeDispatcher", "lower")}


def _public(path: Path):
    """(names, {class: methods}) a module defines at its top level, and
    for a package's ``__init__`` the names it imports as well."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            classes[node.name] = {b.name for b in node.body
                                  if isinstance(b, ast.FunctionDef)}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level and \
                path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    pub = {n for n in names if not n.startswith("_")}
    return pub, {c: {m for m in ms if not m.startswith("_")}
                 for c, ms in classes.items() if not c.startswith("_")}


def test_public_names_have_counterparts():
    """Every public name of every JAX package module has a counterpart in
    the port's module of the same path, apart from ROADMAP.md §1's
    list.  The models are ``nn.Module``s: a reference function over a
    parameter tree (``init_params``, ``apply``, ``loss_fn``, ...) is the
    constructor or a method of the same name of a module class there (or
    of ``models/gnn/common.py``'s ``MLP`` and ``Potential``)."""
    _, common = _public(PORT / "models" / "gnn" / "common.py")
    missing = []
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        port = PORT / rel
        if rel in NO_COUNTERPART:
            assert not port.exists(), rel
            continue
        if not port.exists():
            missing.append(rel)
            continue
        r_names, r_classes = _public(ref)
        p_names, p_classes = _public(port)
        methods = set().union(*p_classes.values(), *common.values()) \
            if rel.startswith("models/") else set()
        for name in sorted(r_names - p_names):
            if rel.startswith("models/") and (
                    name in methods or name == "init_params"
                    or (name in ("mlp_init", "mlp_apply")
                        and "MLP" in common)):
                continue
            missing.append(f"{rel}: {name}")
        for cls, members in r_classes.items():
            for name in sorted(members - p_classes.get(cls, set())):
                if (rel, cls, name) not in NO_MEMBER:
                    missing.append(f"{rel}: {cls}.{name}")
    assert not missing, missing
