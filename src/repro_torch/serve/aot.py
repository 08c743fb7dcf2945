"""AOT-exported engine phases: cold-start serving from a disk cache.

A serving process restarting on the same (backend, device, index shapes,
batch granule, knobs) traces the same query phases its predecessor
traced.  This module keeps them as ``torch.export`` programs: an
``ExportedProgram`` saved with ``torch.export.save`` (a ``.pt2`` file) is
the counterpart of a serialized ``jax.export`` artifact.  The cache is
keyed on everything that determines a program:

    key = sha256(tag, backend, torch version, device (type; on CUDA its
                 name and capability), the inputs' shapes and dtypes and
                 the values of their non-tensor leaves, mesh, config)

``QueryEngine.aot_warmup(index, cache_dir)`` drives it: hits put the
loaded programs behind the engine's dispatch points, misses export this
process's phases so that the next process hits.  A program calls the
four kernels as the ``repro_torch`` custom ops (``repro_torch.kernels``
registers them at import), so a loaded program launches the same
hand-written kernels as the live phase, and its answers are bitwise the
same.  A loaded program runs as the graph module that
``ExportedProgram.module()`` builds: Python code over the recorded
torch ops, with no machine code cached.

Scope: the replicated single-process layout.  A mesh engine's collectives
are bound to its process group, which a restarted process cannot carry
over; ``aot_warmup`` refuses it.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import time
import warnings

import torch
import torch.utils._pytree as pytree

import repro_torch.kernels  # noqa: F401  (registers the custom ops)
from repro_torch.core.graph import Graph
from repro_torch.core.query import PackedLabels

#: the cache files' suffix
SUFFIX = ".pt2"


class AOTCacheWarning(UserWarning):
    """An AOT cache entry could not be exported or loaded; serving goes on
    through the live phase, which runs the same kernels (answers are
    unaffected)."""


_REGISTERED = False


def _ensure_serialization_registered():
    """``torch.export`` refuses dataclass inputs it does not know; register
    the engine's two as pytrees, with names that a fresh process resolves,
    once (idempotent across engines and tests)."""
    global _REGISTERED
    if _REGISTERED:
        return
    for cls in (PackedLabels, Graph):
        try:
            torch.export.register_dataclass(
                cls, serialized_type_name=f"repro_torch.core.{cls.__name__}")
        except ValueError:
            pass  # an earlier registration in this process holds
    _REGISTERED = True


# at import: a fresh process that loads a program rebuilds its input trees
_ensure_serialization_registered()


def avals_desc(args) -> list:
    """(shape, dtype) of each tensor leaf of a call's inputs, the value of
    each other leaf (a branch flag, a None), and the tree's structure."""
    leaves, spec = pytree.tree_flatten(args)
    return [str(spec)] + [(tuple(x.shape), str(x.dtype))
                          if isinstance(x, torch.Tensor) else repr(x)
                          for x in leaves]


def device_desc(args) -> list:
    """The device of a call's tensors: its type, and on CUDA the card's
    name and compute capability."""
    for x in pytree.tree_leaves(args):
        if isinstance(x, torch.Tensor):
            dev = x.device
            if dev.type == "cuda":
                return [dev.type, torch.cuda.get_device_name(dev),
                        list(torch.cuda.get_device_capability(dev))]
            return [dev.type]
    return []


class ShapeDispatcher:
    """Callable that routes by inputs: a call whose dispatch key was added
    goes to its loaded program, anything else to the live phase
    ``fallback``.  An exported program serves one input signature, while
    an engine phase serves several shapes and branches.

    ``key(*args)`` names the few things that vary between one engine's
    calls of the phase (a batch size, a branch flag, the index's sizes),
    so that a call reads a handful of attributes, not the whole input
    tree.  The key must determine the call's ``avals_desc``; ``add``
    computes those once and refuses a second program under one key with
    other ones.  ``loaded_calls`` and ``live_calls`` count the two
    routes."""

    def __init__(self, fallback, key):
        self.fallback = fallback
        self.key = key
        self.table: dict = {}
        self.loaded_calls = 0
        self.live_calls = 0

    def add(self, args, fn):
        k = self.key(*args)
        avals = avals_desc(args)
        if k in self.table and self.table[k][1] != avals:
            raise ValueError(f"dispatch key {k!r} covers two input "
                             "signatures; the key must name what differs")
        self.table[k] = (fn, avals)

    def __call__(self, *args):
        hit = self.table.get(self.key(*args))
        if hit is None:
            self.live_calls += 1
            return self.fallback(*args)
        self.loaded_calls += 1
        return hit[0](*args)


class _Phase(torch.nn.Module):
    """A phase function as the module ``torch.export.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class AOTCache:
    """Disk cache of ``torch.export`` programs, one ``<key>.pt2`` each.

    ``hits``, ``misses`` and ``stores`` count entries; ``log`` keeps one
    record an entry: the tag, what happened (``"store"``, ``"load"``,
    ``"miss"``, ``"unusable"``, ``"export failed"``) and its times in ms
    (``export_ms`` and ``save_ms``, or ``load_ms``) and bytes."""

    def __init__(self, path: str | pathlib.Path):
        _ensure_serialization_registered()
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.log: list[dict] = []

    @staticmethod
    def key(tag: str, backend: str, args, mesh_desc=None,
            config: dict | None = None) -> str:
        """``config`` must carry every engine knob a program bakes in
        beyond its inputs (``max_iters``, the BFS loop's bound on the
        host, the frontier layout, ``bfs_kernel``, ...), otherwise a
        process restarted with other knobs would serve the old program's
        semantics."""
        blob = json.dumps({"tag": tag, "backend": backend,
                           "torch": torch.__version__,
                           "device": device_desc(args),
                           "avals": avals_desc(args),
                           "mesh": mesh_desc,
                           "config": config or {}}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def _file(self, key: str) -> pathlib.Path:
        return self.path / f"{key}{SUFFIX}"

    def load(self, key: str, tag: str = ""):
        """The stored program as a callable, or None.  A missing entry is
        a miss; an unusable one (truncated, from another torch, an op not
        registered) warns ``AOTCacheWarning`` and is a miss, never a
        serving failure."""
        f = self._file(key)
        if not f.exists():
            self.misses += 1
            self.log.append({"tag": tag, "key": key, "event": "miss"})
            return None
        t = time.perf_counter()
        try:
            fn = torch.export.load(f).module()
        except Exception as e:  # version skew, a truncated file, ...
            warnings.warn(f"AOT cache entry {f.name} unusable ({e!r}); "
                          "serving it live", AOTCacheWarning, stacklevel=2)
            self.misses += 1
            self.log.append({"tag": tag, "key": key, "event": "unusable"})
            return None
        # a ShapeDispatcher calls it only on inputs whose dispatch key,
        # and so whose tree, shapes, dtypes and other leaves, equal the
        # exported ones, so the module's own check of each call's inputs
        # is skipped
        fn.validate_inputs = False
        self.hits += 1
        self.log.append({"tag": tag, "key": key, "event": "load",
                         "load_ms": (time.perf_counter() - t) * 1e3,
                         "bytes": f.stat().st_size})
        return fn

    def store(self, key: str, fn, args, tag: str = "") -> None:
        """Export ``fn`` at ``args`` and save it without its example
        inputs (they would copy the index into every file).  A failure
        warns and skips: the live phase goes on serving."""
        f = self._file(key)
        try:
            t = time.perf_counter()
            ep = torch.export.export(_Phase(fn), tuple(args))
            ep.example_inputs = None
            t_save = time.perf_counter()
            torch.export.save(ep, f)
            t_end = time.perf_counter()
        except Exception as e:
            warnings.warn(f"AOT export failed for {key} ({e!r}); entry "
                          "skipped", AOTCacheWarning, stacklevel=2)
            self.log.append({"tag": tag, "key": key,
                             "event": "export failed"})
            return
        self.stores += 1
        self.log.append({"tag": tag, "key": key, "event": "store",
                         "export_ms": (t_save - t) * 1e3,
                         "save_ms": (t_end - t_save) * 1e3,
                         "bytes": f.stat().st_size})
