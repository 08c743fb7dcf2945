"""Build and load the CUDA sources under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain ``extern "C"`` interface, written to
``build/repro_torch_kernels/<hash>/lib<name>.so`` at the root of the
checkout (the hash covers the source, every ``csrc/*.cuh`` header it may
include and the flags), and is loaded with ``ctypes``.  The compiler's
``-Xptxas -v`` report (registers and spills per kernel instance) is kept
beside it as ``lib<name>.log`` (``ptxas_report``).  Nothing is built when a
module is imported: the CPU never needs the libraries.

``register_op`` binds a kernel to torch as an operator of the
``repro_torch`` library, at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int

#: entry points of each library with their (argument types, result type),
#: set once at load: device pointers and the stream are ``c_void_p``,
#: sizes and totals ``c_int``.  Launch entry points return a cudaError_t.
SIGNATURES = {
    "dbl_query": {"dbl_query_verdicts": (
        [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I,
         _P, _I, _I, _I, _I, _P], _I)},
    "bfs_prune": {"bfs_admit_plane": (
        [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I)},
    "dbl_query_streamed": {"dbl_query_verdicts_streamed": (
        [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I,
         _P], _I)},
    "bfs_prune_streamed": {"bfs_admit_plane_streamed": (
        [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I)},
    "pack_planes": {"pack_label_planes": ([_P] * 8 + [_I] * 7 + [_P], _I)},
    "bfs_relax": {"bfs_relax": ([_P] * 7 + [_I] * 4 + [_P], _I)},
}

#: shared memory a block may take on Hopper (227 KB), see the opt-in in
#: the sources
MAX_SMEM_BYTES = 232_448

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: a directory named by the hash of
    the flags, the source and every header under ``csrc/``, so that an
    edit to a shared header rebuilds each library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library exists.  Returns
    (process, temp output, final path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)   # atomic: a concurrent build sees all or none


def build(names) -> None:
    """Compile the named sources, one ``nvcc`` each, all started together."""
    names = list(names)
    started = [_start(n) for n in names]
    for n, s in zip(names, started):
        _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        for entry, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = restype
        _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per kernel function of the built library
    ``lib<name>.so``, read from the compiler's ``-Xptxas -v`` log (mangled
    names, demangled by ``c++filt`` where it is on the PATH)."""
    log = library_path(name).with_suffix(".log").read_text()
    out: dict[str, dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                    r"bytes spill loads", line)):
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(out), text=True,
                               capture_output=True).stdout.splitlines()
        if len(names) == len(out):
            out = dict(zip(names, out.values()))
    return out


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{what} failed to launch: cuda error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (persistent grids)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


#: the torch operator library of the kernels (``register_op``)
_OPS = torch.library.Library("repro_torch", "DEF")


def register_op(name: str, schema: str, cpu, cuda, fake):
    """Define the operator ``repro_torch::<name>`` with ``schema`` (its
    arguments and result, without the name), its CPU and CUDA kernels and
    its fake kernel (the output's shape and dtype, what ``torch.export``
    traces with), and return it (``torch.ops.repro_torch.<name>``).
    Through ``torch.library.define``/``impl``/``register_fake``: a call
    costs the C++ dispatcher only, where ``torch.library.custom_op``
    wraps every call in a Python autograd kernel, which these
    inference-only ops do not need."""
    qual = f"repro_torch::{name}"
    torch.library.define(qual, schema, lib=_OPS)
    torch.library.impl(qual, "cpu", lib=_OPS)(cpu)
    torch.library.impl(qual, "cuda", lib=_OPS)(cuda)
    torch.library.register_fake(qual, lib=_OPS)(fake)
    return getattr(torch.ops.repro_torch, name).default
