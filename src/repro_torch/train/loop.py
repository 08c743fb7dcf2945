"""Training loop substrate: TrainState, the step factory with gradient
accumulation (fp32 accumulators over microbatches, one optimizer
application a step) and the host loop.

The state's ``params`` is a nested dict of tensors shaped as the JAX
reference's parameter tree, ``opt_state`` the optimizer's NamedTuple of
trees shaped to match; ``step`` (int32) and ``rng`` (a (2,) uint32
threefry key) stay on the host, so neither the key derivation
(``fold_in``, in numpy) nor ``run``'s ``int(state.step)`` waits for the
device.  A step differentiates ``loss_fn`` with ``torch.autograd.grad``
over the parameter leaves; ``lm_loss`` makes such a ``loss_fn`` of a
``Transformer`` by swapping the tree into the module
(``torch.func.functional_call``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core._threefry import fold_in
from repro_torch.models.params import (bound_call, tree_leaves, tree_map,
                                       tree_unflatten)
from .compress import make_grad_transform
from .optim import OPTIMIZERS


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: np.int32
    rng: np.ndarray


def init_state(rng, params, optimizer: str = "adamw") -> TrainState:
    """``rng``: a threefry key, e.g. ``_threefry.seed_key(seed)``."""
    opt_init, _ = OPTIMIZERS[optimizer]
    return TrainState(params, opt_init(params), np.int32(0),
                      np.array(rng, np.uint32))


def lm_loss(model: nn.Module, constrain=None) -> Callable:
    """``loss_fn(params, batch, rng) -> (loss, metrics)`` of a
    ``Transformer``: its ``loss_fn(batch["tokens"], batch["targets"])``
    with the tree ``params`` in place of the module's own parameters (the
    reference's ``M.loss_fn(p, cfg, tokens, targets, constrain=)``;
    ``rng`` unused).  Under ``cfg.remat`` the recomputed layers read the
    same swapped tensors: each layer's slices are taken before its
    checkpoint."""
    kw = {} if constrain is None else {"constrain": constrain}
    call = bound_call(model, "loss_fn", **kw)

    def loss_fn(params, batch, rng):
        del rng
        return call(params, batch["tokens"], batch["targets"])
    return loss_fn


def _value_and_grad(loss_fn, params, batch, rng):
    """(loss, metrics, grads): the gradient tree is shaped as ``params``
    (zeros where the loss does not reach, as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, rng)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                       else x, metrics)
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, *, optimizer: str = "adamw",
                    lr_schedule: Callable, accum: int = 1,
                    grad_codec: str | None = None,
                    donate: bool = True, jit: bool = True,
                    state_shardings=None) -> Callable:
    """loss_fn(params, batch, rng) -> (loss, metrics).

    With accum > 1, ``batch`` leaves must have a leading microbatch axis of
    size ``accum``; gradients are accumulated in fp32, every microbatch
    seeing the key ``fold_in(rng, 1)``, and the metrics are ``{"loss"}``
    only.  The codec's transform, the schedule and the optimizer run once
    after accumulation.

    ``donate=True`` updates the state's tensors in place (the caller's
    state is consumed, as a donated buffer is); ``donate=False`` leaves it
    untouched.  ``jit`` is accepted for the reference's signature and has
    no effect: the step runs eagerly.

    ``state_shardings``, a TrainState-shaped tree of
    ``launch.sharding.Layout``s over one live mesh (``lm_state_shardings``
    of the state's shapes), makes the step SPMD: every rank calls it with
    its shard of every state leaf and its block of the batch (the
    ``lm_batch_shardings`` block: the ranks of a model group hold the same
    rows).  The step gathers each parameter into its compute layout (whole,
    or the expert stacks split over the model axis under
    ``moe_impl="shard_map"``), differentiates the rank's loss, sums each
    gradient over the ranks whose compute layout replicates it and divides
    by the mesh size, keeps its shard and updates the shard.  That is the
    gradient of the global batch's mean loss: the ranks of a model group
    compute the same loss on the same block, and every gradient outside
    the sharded MoE is alike on them (``moe_sharded.slice_rows``), while
    inside it each rank's share is scaled to count once in the sum.  The
    optimizer's reductions and ``grad_norm`` run over the ranks that split
    a leaf, the metrics are means over the mesh.  Compute within a model
    group is replicated, except in the sharded MoE's experts.  A local
    ``moe_ffn`` (``moe_impl="pjit"``) takes its capacity and aux loss from
    the rank's block, not the global batch.  On a mesh of one rank the
    step is the unsharded one, bit for bit.
    """
    _, opt_update = OPTIMIZERS[optimizer]
    gt = make_grad_transform(grad_codec)
    if state_shardings is not None:
        return _sharded_step(loss_fn, opt_update, gt, grad_codec,
                             lr_schedule, accum, donate, state_shardings)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        rng = fold_in(state.rng, state.step)
        loss, metrics, grads = _grads(loss_fn, state.params, batch, rng,
                                      accum)
        grads = gt(grads)
        lr = lr_schedule(state.step)
        params, opt_state = opt_update(grads, state.opt_state, state.params,
                                       lr=lr, inplace=donate)
        metrics = dict(metrics)
        metrics["lr"] = lr
        metrics["grad_norm"] = torch.sqrt(sum(
            torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        return TrainState(params, opt_state, np.int32(int(state.step) + 1),
                          state.rng), metrics

    return step


def _grads(loss_fn, params, batch, rng, accum: int):
    """(loss, metrics, grads) of one step: one batch, or ``accum``
    microbatches averaged in float32 (each seeing ``fold_in(rng, 1)``,
    metrics ``{"loss"}`` only)."""
    if accum == 1:
        return _value_and_grad(loss_fn, params, batch, rng)
    key = fold_in(rng, 1)
    gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)]
    loss = torch.zeros((), dtype=torch.float32, device=gacc[0].device)
    for i in range(accum):
        mb = tree_map(lambda x, i=i: x[i], batch)
        mb_loss, _, grads = _value_and_grad(loss_fn, params, mb, key)
        for a, g in zip(gacc, tree_leaves(grads)):
            a.add_(g.float() / accum)
        loss = loss + mb_loss / accum
        del grads
    return loss, {"loss": loss}, tree_unflatten(params, gacc)


def _sharded_step(loss_fn, opt_update, gt, grad_codec, lr_schedule,
                  accum: int, donate: bool, layouts) -> Callable:
    p_lays = tree_leaves(layouts.params)
    mesh = p_lays[0].mesh
    n = mesh.size
    if grad_codec == "int8" and any(
            e is not None for lay in p_lays for e in (lay.compute or ())):
        raise ValueError("grad_codec='int8' scales each gradient by its "
                         "largest element, which a leaf computed split "
                         "over the model axis does not hold whole")

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        rng = fold_in(state.rng, state.step)
        full = tree_unflatten(state.params, [
            lay.to_compute(s) for lay, s in zip(p_lays,
                                                tree_leaves(state.params))])
        loss, metrics, grads = _grads(loss_fn, full, batch, rng, accum)
        del full
        grads = tree_leaves(grads)
        if n > 1:           # in place: the gradients are the step's own
            for lay, g in zip(p_lays, grads):
                lay.psum(g, lay.compute_replicas()).div_(n)
        grads = tree_leaves(gt(tree_unflatten(state.params, grads)))
        grads = tree_unflatten(state.params, [
            lay.from_compute(g).contiguous() if lay.split_axes() else g
            for lay, g in zip(p_lays, grads)])
        lr = lr_schedule(state.step)
        params, opt_state = opt_update(
            grads, state.opt_state, state.params, lr=lr, inplace=donate,
            layouts=(layouts.params, layouts.opt_state))
        metrics = dict(metrics)
        if n > 1:
            names = [k for k, v in metrics.items()
                     if isinstance(v, torch.Tensor) and v.numel() == 1]
            if names:
                vals = torch.stack([metrics[k].float().reshape(())
                                    for k in names])
                vals = p_lays[0].psum(vals, mesh.axis_names) / n
                metrics.update(zip(names, vals.unbind()))
        metrics["lr"] = lr
        metrics["grad_norm"] = torch.sqrt(sum(_sq_norms(
            tree_leaves(grads), p_lays)))
        return TrainState(params, opt_state, np.int32(int(state.step) + 1),
                          state.rng), metrics

    return step


def _sq_norms(shards, lays) -> list:
    """Each leaf's squared norm from this rank's shard: summed over the
    ranks that split the leaf (one all-reduce for the leaves split over
    the same axes), so a replicated leaf counts once."""
    parts = [torch.sum(torch.square(g.float())) for g in shards]
    groups: dict = {}
    for i, lay in enumerate(lays):
        if lay.split_axes():
            groups.setdefault(lay.split_axes(), []).append(i)
    for axes, idx in groups.items():
        tot = lays[idx[0]].psum(torch.stack([parts[i] for i in idx]), axes)
        for i, t in zip(idx, tot.unbind()):
            parts[i] = t
    return parts


def run(state: TrainState, step_fn, data_iter, *, n_steps: int,
        hooks: list | None = None, log_every: int = 10) -> TrainState:
    """Host-side loop: pull batches, run steps, fire hooks (checkpoint,
    metrics, failure injection in tests)."""
    hooks = hooks or []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        step = int(state.step)
        if step % log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {step} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        for hook in hooks:
            hook(state, metrics)
    return state
