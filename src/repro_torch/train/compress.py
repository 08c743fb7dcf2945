"""Gradient compression for cross-replica reduction.

Three codecs, each the JAX reference's arithmetic:
- bf16:   cast-before-reduce (2x traffic cut, standard at scale);
- int8:   per-tensor max-scaled symmetric quantization (round half to
          even, as ``jnp.round``);
- topk:   magnitude top-k sparsification **with error feedback** (the
          residual is carried to the next step, preserving convergence).

``compressed_psum`` is the collective building block over
``torch.distributed`` (a process group in place of the reference's named
mesh axis); ``make_grad_transform`` is the train loop's hook that applies
a codec's precision to the already summed gradient tree.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten


def bf16_compress(g):
    return tree_map(lambda x: x.to(torch.bfloat16), g)


def bf16_decompress(g):
    return tree_map(lambda x: x.to(torch.float32), g)


def int8_encode(x: torch.Tensor):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def topk_sparsify(x: torch.Tensor, frac: float):
    """Keep the top ``frac`` fraction by magnitude; returns (sparse,
    residual).  The threshold is the k-th largest magnitude and every
    element at or above it is kept, ties included."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat,
                       torch.zeros((), dtype=flat.dtype,
                                   device=flat.device)).reshape(x.shape)
    return kept, x - kept


def topk_with_error_feedback(grads, residuals, frac: float):
    """g' = topk(g + residual); residual' = (g + residual) - g'."""
    pairs = tree_leaves(tree_map(
        lambda g, r: topk_sparsify(g.float() + r, frac), grads, residuals))
    return (tree_unflatten(grads, pairs[0::2]),
            tree_unflatten(grads, pairs[1::2]))


def compressed_psum(g: torch.Tensor, group=None, codec: str = "bf16"):
    """compress -> all_reduce over ``group`` -> decompress: every rank
    returns the float32 sum of every rank's ``g``."""
    if codec == "bf16":
        t = g.to(torch.bfloat16, copy=True)
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
        return t.to(torch.float32)
    if codec == "int8":
        _, scale = int8_encode(g)
        # int8 summation must widen; scale is reduced with max for safety
        s = scale.reshape(1)
        dist.all_reduce(s, dist.ReduceOp.MAX, group=group)
        s = s.reshape(())
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, dist.ReduceOp.SUM, group=group)
        return tot.to(torch.float32) * s
    if codec == "none":
        t = g.clone()
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
        return t
    raise ValueError(codec)


def make_grad_transform(codec: str | None) -> Callable:
    """Loop hook: applied to the (already summed) gradient tree,
    simulating the precision of a compressed reduction."""
    if codec in (None, "none"):
        return lambda g: g
    if codec == "bf16":
        return lambda g: bf16_decompress(bf16_compress(g))
    if codec == "int8":
        def f(g):
            return tree_map(lambda x: int8_decode(*int8_encode(x.float())),
                            g)
        return f
    raise ValueError(codec)
