"""The bridge between a parameter tree of numpy arrays (nested dicts and
lists, the JAX reference's layout) and an ``nn.Module`` whose
``named_parameters()`` names are the tree's dotted paths: load a tree in,
read the gradients out under the same names, and the plain SGD update the
models' examples and smoke runs take."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix: str = "") -> dict:
    """{dotted name: leaf} of a nested dict/list tree; a dict key (an int
    irrep order included) becomes ``str(key)``, a list index its digits,
    and ``None`` leaves are skipped.  The names are the module's
    ``named_parameters`` names."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def load_numpy_params(module: nn.Module, tree) -> nn.Module:
    """Copy a reference parameter tree of numpy arrays into ``module``'s
    parameters (same names, shapes; values cast to each parameter's dtype
    and device).  Every parameter must be given and every leaf used."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"tree and module differ: only in the tree "
                       f"{sorted(set(flat) - set(params))}, only in the "
                       f"module {sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            val = np.asarray(flat[name])
            if val.dtype.name == "bfloat16":     # numpy has no such type:
                val = val.astype(np.float32)     # widen, exactly
            val = torch.tensor(val)
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(val.shape)} for a "
                                 f"parameter of {tuple(p.shape)}")
            p.copy_(val.to(dtype=p.dtype, device=p.device))
    return module


def grads_to_numpy(module: nn.Module) -> dict:
    """{dotted name: gradient as numpy} under the names ``flatten_tree``
    gives the reference's gradient tree; a parameter the loss did not reach
    has a zero gradient, as ``jax.grad`` gives it."""
    return {name: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                   else p.grad.detach().float().cpu().numpy())
            for name, p in module.named_parameters()}


def sgd_step(module: nn.Module, lr: float):
    """``w - lr * g`` on every parameter with a gradient, then clear them."""
    with torch.no_grad():
        for p in module.parameters():
            if p.grad is not None:
                p.sub_(lr * p.grad)
    module.zero_grad(set_to_none=True)
