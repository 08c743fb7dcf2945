"""Optimizers (no library optimizer): AdamW and Adafactor + LR schedules.

Adafactor (factored second moments) is the default for the >=27B configs:
it keeps one row and one column vector of float32 state per matrix where
Adam keeps two full float32 copies of the weights.

The states are NamedTuples whose moment fields are trees shaped like the
parameters (nested dicts of tensors) and whose ``step`` is a host
``np.int32``, so the bias corrections and the schedule are host floats and
a step reads nothing back from the device.  The arithmetic is the JAX
reference's, in float32, leaf by leaf; a parameter's new value is computed
in float32 and cast back to its storage dtype.  With ``inplace=True`` each
leaf's results are copied into the given parameter and state tensors as
soon as they are computed (the step's ``donate``), so no second state
exists at once; the same trees are returned.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.launch.sharding import Layout, P, relayout
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten


def _apply(upd, trees, params, inplace: bool, layouts=None):
    """``upd`` over the leaves of ``trees`` (gradients, state trees...)
    and ``params``: the new parameter tree and one tree per state output.
    ``inplace`` copies every output into its input tensor (the state
    trees' leaves are ``trees[1:]``) and returns those.  ``layouts``, a
    pair (parameter layouts, the state's layouts), gives ``upd`` each
    leaf's layouts as ``lay=(parameter's, state leaves'...)``."""
    cols = [tree_leaves(t) for t in trees] + [tree_leaves(params)]
    if layouts is not None:
        p_lays, s_lays = layouts
        lays = list(zip(tree_leaves(p_lays), *(
            tree_leaves(t) for t in tuple(s_lays)[:len(trees) - 1])))
    outs = []
    for i, leaf in enumerate(zip(*cols)):
        res = upd(*leaf) if layouts is None else upd(*leaf, lay=lays[i])
        if inplace:
            with torch.no_grad():
                for dst, new in zip((leaf[-1],) + leaf[1:-1], res):
                    dst.copy_(new)
            res = (leaf[-1],) + leaf[1:-1]
        outs.append(res)
    return [tree_unflatten(params, [o[i] for o in outs])
            for i in range(len(trees))]


def _mean(x, dim: int, lay, pdim: int, keepdim: bool = False):
    """``x.mean(dim)``, where ``x``'s ``dim`` is dimension ``pdim`` of a
    parameter laid out as ``lay``: over the ranks that split it, a local
    sum all-reduced over them, divided by the whole extent."""
    axes = () if lay is None else tuple(
        a for a in lay.axes(pdim) if lay.mesh.sizes[a] > 1)
    if not axes:
        return x.mean(dim=dim, keepdim=keepdim)
    total = lay.psum(x.sum(dim=dim, keepdim=keepdim), axes)
    return total / (x.shape[dim] * lay.parts(pdim))


def _mean_all(x, lay):
    """``torch.mean(x)`` of a tensor laid out as ``lay``."""
    axes = () if lay is None else lay.split_axes()
    if not axes:
        return torch.mean(x)
    return lay.psum(x.sum(), axes) / (x.numel() * int(np.prod(
        [lay.mesh.sizes[a] for a in axes])))


def _natural(lay, dims):
    """The layout of a tensor whose dimensions are ``dims`` of a leaf laid
    out as ``lay`` (a reduction's result)."""
    return Layout(lay.mesh, P(*(lay.spec[d] if d < len(lay.spec) else None
                                for d in dims)))


def _f32(x: float) -> float:
    """A host float rounded to float32, as the reference's float32 scalars
    are (torch then uses it exactly)."""
    return float(np.float32(x))


# ------------------------------------------------------------------- AdamW
class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: np.int32


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(tree_map(zeros, params), tree_map(zeros, params),
                      np.int32(0))


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, inplace: bool = False,
                 layouts=None):
    """One AdamW step.  ``layouts`` (parameter layouts, state layouts):
    every leaf is this rank's shard (``make_train_step(
    state_shardings=)``); a moment held otherwise than its parameter is
    brought to the parameter's layout and back."""
    step = np.int32(int(state.step) + 1)
    bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(step))
    lr = _f32(lr)

    @torch.no_grad()
    def upd(g, m, v, p, lay=None):
        if lay is not None:
            m, v = relayout(m, lay[1], lay[0]), relayout(v, lay[2], lay[0])
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p.float()
        if lay is not None:
            m, v = relayout(m, lay[0], lay[1]), relayout(v, lay[0], lay[2])
        return (p - lr * u).to(p.dtype), m, v

    new_p, new_m, new_v = _apply(upd, (grads, state.m, state.v), params,
                                 inplace, layouts)
    return new_p, AdamWState(new_m, new_v, step)


# --------------------------------------------------------------- Adafactor
class AdafactorState(NamedTuple):
    vr: dict   # row second moments (or full v for <2D leaves)
    vc: dict   # col second moments (zeros for <2D leaves)
    step: np.int32


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    def rows(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(tree_map(rows, params), tree_map(cols, params),
                          np.int32(0))


def adafactor_update(grads, state: AdafactorState, params, *, lr,
                     decay=0.99, eps=1e-30, clip=1.0, weight_decay=0.0,
                     inplace: bool = False, layouts=None):
    """One Adafactor step.  ``layouts`` (parameter layouts, state
    layouts): every leaf is this rank's shard; the row and column means,
    the mean of the row moments and the update's RMS reduce over the ranks
    that split the leaf, and the moments move between their own layouts
    and the ones those means leave them in."""
    step = np.int32(int(state.step) + 1)
    lr = _f32(lr)

    @torch.no_grad()
    def upd(g, vr, vc, p, lay=None):
        lp = None if lay is None else lay[0]
        nd = p.ndim
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            if lay is not None:
                nat_r = _natural(lp, range(nd - 1))
                nat_c = _natural(lp, list(range(nd - 2)) + [nd - 1])
                vr, vc = relayout(vr, lay[1], nat_r), relayout(vc, lay[2],
                                                               nat_c)
            vr = decay * vr + (1 - decay) * _mean(g2, -1, lp, nd - 1)
            vc = decay * vc + (1 - decay) * _mean(g2, -2, lp, nd - 2)
            denom = (vr / torch.clamp(_mean(vr, -1, lp, nd - 2, True),
                                      min=eps))[..., None] * vc[..., None, :]
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            if lay is not None:
                vr, vc = relayout(vr, nat_r, lay[1]), relayout(vc, nat_c,
                                                               lay[2])
        else:
            if lay is not None:
                vr = relayout(vr, lay[1], lp)
            vr = decay * vr + (1 - decay) * g2
            u = g * torch.rsqrt(torch.clamp(vr, min=eps))
            if lay is not None:
                vr = relayout(vr, lp, lay[1])
        # update clipping (RMS <= clip)
        rms = torch.sqrt(_mean_all(u * u, lp) + eps)
        u = u / torch.clamp(rms / clip, min=1.0)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p - lr * u).to(p.dtype), vr, vc

    new_p, new_vr, new_vc = _apply(upd, (grads, state.vr, state.vc), params,
                                   inplace, layouts)
    return new_p, AdafactorState(new_vr, new_vc, step)


# -------------------------------------------------------------- schedules
def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) -> np.float32: linear warm-up, then a cosine to 0 at
    ``total``, computed in float32 on the host as the reference computes
    it on the device."""
    def lr(step):
        step = np.float32(step)
        warm = base_lr * step / np.float32(max(warmup, 1))
        frac = np.clip((step - np.float32(warmup))
                       / np.float32(max(total - warmup, 1)),
                       np.float32(0), np.float32(1))
        cos = np.float32(base_lr * 0.5) * (
            np.float32(1) + np.cos(np.float32(np.pi) * frac))
        return np.float32(warm if step < warmup else cos)
    return lr


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}
