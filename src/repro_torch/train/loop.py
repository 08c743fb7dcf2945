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
from torch.func import functional_call

from repro_torch.core._threefry import fold_in
from repro_torch.core.planes import not_ported
from repro_torch.models.params import (flatten_tree, tree_leaves, tree_map,
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


class _LossCall(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, tokens, targets):
        return self.model.loss_fn(tokens, targets)


def lm_loss(model: nn.Module) -> Callable:
    """``loss_fn(params, batch, rng) -> (loss, metrics)`` of a
    ``Transformer``: its ``loss_fn(batch["tokens"], batch["targets"])``
    with the tree ``params`` in place of the module's own parameters (the
    reference's ``M.loss_fn(p, cfg, tokens, targets)``; ``rng`` unused).
    Under ``cfg.remat`` the recomputed layers read the same swapped
    tensors: each layer's slices are taken before its checkpoint."""
    call = _LossCall(model)

    def loss_fn(params, batch, rng):
        del rng
        flat = {f"model.{k}": v for k, v in flatten_tree(params).items()}
        return functional_call(call, flat,
                               (batch["tokens"], batch["targets"]))
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
    no effect: the step runs eagerly.  ``state_shardings`` (a layout over
    several devices) is not ported yet.
    """
    if state_shardings is not None:
        raise not_ported("make_train_step(state_shardings=)",
                         "§1 17f, launch/")
    _, opt_update = OPTIMIZERS[optimizer]
    gt = make_grad_transform(grad_codec)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        rng = fold_in(state.rng, state.step)
        if accum == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, state.params,
                                                   batch, rng)
        else:
            key = fold_in(rng, 1)
            gacc = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                    for p in tree_leaves(state.params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=gacc[0].device)
            for i in range(accum):
                mb = tree_map(lambda x, i=i: x[i], batch)
                mb_loss, _, grads = _value_and_grad(loss_fn, state.params,
                                                    mb, key)
                for a, g in zip(gacc, tree_leaves(grads)):
                    a.add_(g.float() / accum)
                loss = loss + mb_loss / accum
                del grads
            grads = tree_unflatten(state.params, gacc)
            metrics = {"loss": loss}

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
