"""Checkpointing: atomic, placement-independent, async-capable,
keep-last-k, in the JAX reference's file layout.

- full arrays are saved (``np.savez``, one ``leaf_<i>`` per leaf in
  ``jax.tree.flatten``'s order: NamedTuple fields in order, dict keys
  sorted), so either package restores what the other wrote, and restore
  places each leaf anew (``like``'s device, or a given placement);
- writes go to ``<dir>/tmp-<step>`` then ``os.replace`` ->
  ``step-<k>`` (atomic on POSIX), so a process killed mid-write can never
  corrupt the latest checkpoint;
- an optional background thread hides the write behind the next step;
  every leaf is copied to host memory before it starts, so a step that
  updates the state in place right after cannot race the writer;
  ``wait()`` on the hook joins before exit.

numpy has no bfloat16: a bfloat16 leaf is written as its raw bits, the
``|V2`` array the reference's writer produces, and read back as those
bits where the ``like`` leaf is bfloat16 (the reference's own restore
cannot cast ``|V2``; this one can).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

_BF16_BITS = np.dtype("V2")


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array that owns its memory (a copy)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.array(x)


def _leaf_like(arr: np.ndarray, ref):
    """``arr`` as ``ref``'s kind of leaf: a tensor of its dtype on its
    device, or a numpy array or scalar of its dtype."""
    if not isinstance(ref, torch.Tensor):
        out = np.asarray(arr, dtype=np.asarray(ref).dtype)
        return out if isinstance(ref, np.ndarray) else out[()]
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")   # torch shares no read-only memory
    if arr.dtype == _BF16_BITS or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=ref.device, dtype=ref.dtype)


def from_numpy_leaves(like: Any, leaves) -> Any:
    """The tree shaped as ``like`` from numpy ``leaves`` in
    ``jax.tree.flatten``'s order: a checkpoint's arrays, or the
    reference's ``jax.tree.leaves(state)`` as numpy.  Each leaf must have
    its ``like`` leaf's shape and is cast to its dtype and device (or to
    a numpy leaf of its dtype); a bfloat16 value may come as ml_dtypes'
    bfloat16 or as its raw ``|V2`` bits."""
    refs = tree_leaves(like)
    leaves = list(leaves)
    if len(leaves) != len(refs):
        raise ValueError(f"{len(leaves)} leaves for a state of {len(refs)}")
    out = []
    for i, (arr, ref) in enumerate(zip(leaves, refs)):
        arr = np.asarray(arr)
        if arr.shape != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: shape {arr.shape} for "
                             f"{tuple(np.shape(ref))}")
        out.append(_leaf_like(arr, ref))
    return tree_unflatten(like, out)


def save(state: Any, ckpt_dir: str, step: int, *, keep: int = 3,
         blocking: bool = True) -> threading.Thread | None:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {f"leaf_{i}": _to_host(x)
              for i, x in enumerate(tree_leaves(state))}

    def write():
        tmp = os.path.join(ckpt_dir, f"tmp-{step}")
        final = os.path.join(ckpt_dir, f"step-{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(arrays)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    return int(steps[-1].split("-")[1]) if steps else None


def restore(ckpt_dir: str, like: Any, *, step: int | None = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (its shapes, dtypes and
    devices).  ``shardings``, a tree shaped as ``like``, places each
    tensor leaf anew: a ``torch.device`` moves the whole leaf there, a
    ``launch.sharding.Layout`` keeps this rank's shard of it on the
    layout's mesh device (``like`` then gives the whole shapes, and may
    be on the meta device)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step-{step:09d}", "arrays.npz")
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(tree_leaves(like)))]
    if shardings is None:
        return from_numpy_leaves(like, leaves)
    host = tree_map(lambda x: torch.empty((), dtype=x.dtype).expand(x.shape)
                    if isinstance(x, torch.Tensor) else x, like)
    state = from_numpy_leaves(host, leaves)

    def place(x, where):
        if not isinstance(x, torch.Tensor):
            return x
        if isinstance(where, torch.device):
            return x.to(where)
        shard = where.shard(x)
        return torch.empty(shard.shape, dtype=shard.dtype,
                           device=where.mesh.device).copy_(shard)
    return tree_map(place, state, shardings)


def checkpoint_hook(ckpt_dir: str, every: int, *, keep: int = 3,
                    blocking: bool = False):
    pending: list[threading.Thread] = []

    def hook(state, metrics):
        step = int(state.step)
        if step % every == 0:
            t = save(state, ckpt_dir, step, keep=keep, blocking=blocking)
            if t is not None:
                pending.append(t)

    def wait():
        for t in pending:
            t.join()

    hook.wait = wait
    return hook
