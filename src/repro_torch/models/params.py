"""The bridge between a parameter tree of numpy arrays (nested dicts and
lists, the JAX reference's layout) and an ``nn.Module`` whose
``named_parameters()`` names are the tree's dotted paths: load a tree in,
read the gradients out under the same names, and the plain SGD update the
models' examples and smoke runs take.

``tree_leaves``, ``tree_map`` and ``tree_unflatten`` walk a tree in
``jax.tree.flatten``'s order (a NamedTuple's fields in order, a dict's
keys sorted, ``None`` an empty subtree), which the training state and its
checkpoints keep; ``flatten_tree`` keeps insertion order, for names."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call


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


def _children(tree):
    """(children, rebuild) of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (list, tuple)):
        return list(tree), type(tree)
    return None


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree.leaves``' order."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[0] for leaf in tree_leaves(child)]


def tree_map(fn, tree, *rest):
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and the
    same-shaped ``rest``, rebuilt as ``tree``."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    others = [_children(r)[0] for r in rest]
    return node[1]([tree_map(fn, c, *(o[i] for o in others))
                    for i, c in enumerate(node[0])])


def tree_unflatten(like, leaves):
    """The tree shaped as ``like`` holding ``leaves`` (in
    ``tree_leaves``' order); every leaf must be used."""
    leaves = list(leaves)
    n = len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class _Call(nn.Module):
    def __init__(self, model: nn.Module, method: str, kw: dict):
        super().__init__()
        self.model, self.method, self.kw = model, method, kw

    def forward(self, *args):
        return getattr(self.model, self.method)(*args, **self.kw)


def bound_call(model: nn.Module, method: str, **kw):
    """``fn(params, *args)``: ``model.<method>(*args, **kw)`` with the tree
    ``params`` (named as ``model.named_parameters()``) in place of the
    module's own parameters (``torch.func.functional_call``)."""
    call = _Call(model, method, kw)

    def fn(params, *args):
        flat = {f"model.{k}": v for k, v in flatten_tree(params).items()}
        return functional_call(call, flat, args)
    return fn


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as the nested dict its dotted names spell
    (every key a string)."""
    out: dict = {}
    for name, p in module.named_parameters():
        *path, last = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = p
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
