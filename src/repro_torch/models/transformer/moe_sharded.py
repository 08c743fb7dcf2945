"""Expert-parallel MoE with an explicit all-to-all over the model axis.

The data movement is an all-to-all carrying exactly the routed slots:
T_local·K·d elements a rank per direction, where an FFN whose experts are
gathered would move the expert weights.

SPMD over ``torch.distributed``, one process per mesh position.  On each
rank:
  x      (T_loc, d)        — this rank's block of the tokens
  router (d, E)            — replicated
  w1/w3  (E/tp, d, f), w2 (E/tp, f, d) — this rank's experts (model axis)
Local top-k routing -> local capacity buffer (E, c, d) -> all-to-all
over the model axis (split experts / concat capacity) -> local expert
GLU -> reverse all-to-all -> local combine.  Capacity is per rank (GShard
local capacity): drop patterns differ from the global-capacity
``moe.moe_ffn``; the outputs are equal in the no-drop regime.

Gradients.  ``torch.autograd`` differentiates each rank's program; every
collective carries its adjoint.  The all-to-all's adjoint is the reverse
all-to-all, so each rank's expert gradients collect every slot routed to
its experts from the ranks of its model group.  ``aux`` is the mean over
every rank of the per-rank ``aux_loc``; its backward hands each rank's
``aux_loc`` the rank's own upstream gradient, which is the adjoint of the
mean when every rank's loss takes ``aux`` with the same weight (each
rank's loss is its share of the global loss, and the shares of ``aux``
sum to one ``aux``).  A rank's router (and shared-expert) gradient covers
its own tokens only: the global gradient of a replicated leaf is the sum
over the ranks, of an expert leaf the sum over the ranks that hold the
same experts.  ``train.loop.make_train_step(state_shardings=)`` combines
them so; ``slice_rows``/``gather_rows`` fit this MoE into a model group
that computes one loss (``launch.cells.lm_constrain``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import MoEConfig
from .moe import _glu, _counts, einsum, route


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()          # (a gradient may come as a strided view)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal blocks of dim 0; its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _MeanOver(torch.autograd.Function):
    """The mean of a scalar over the ranks of ``groups`` (one all-reduce a
    group); the backward passes each rank its own upstream gradient (see
    the module docstring)."""

    @staticmethod
    def forward(ctx, x, groups, n):
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks over ``group`` (rank order); the backward
    keeps this rank's block times the group size (see
    :func:`gather_rows`)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rank, ctx.n, ctx.rows = rank, n, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows] * ctx.n, None, None, None


class _SliceRows(torch.autograd.Function):
    """This rank's block of rows; the backward places the block's gradient
    in its rows and averages over ``group`` (see :func:`slice_rows`)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.rank, ctx.n, ctx.shape = group, rank, n, x.shape
        rows = x.shape[0] // n
        return x[rank * rows:(rank + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        rows = ctx.shape[0] // ctx.n
        full = g.new_zeros(ctx.shape)
        full[ctx.rank * rows:(ctx.rank + 1) * rows] = g
        dist.all_reduce(full, group=ctx.group)
        return full / ctx.n, None, None, None


def exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The differentiable all-to-all over ``axis`` (identity on one rank)."""
    if mesh.sizes[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis))


def slice_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's block (at its ``axis`` coordinate) of rows that every
    rank of ``axis`` holds alike.  With :func:`gather_rows` it brackets a
    computation split over ``axis`` inside one that the ranks of ``axis``
    replicate (a model group computing one loss): the gather's backward
    keeps the rank's block times the group size, the slice's backward
    averages the blocks' gradients over the group.  Gradients outside the
    bracket then stay alike on every rank of the group, and every leaf's
    gradient, summed over the ranks and divided by the mesh size, is the
    gradient of the mean of the model groups' losses."""
    n = mesh.sizes[axis]
    if n == 1:
        return x
    return _SliceRows.apply(x, mesh.get_group(axis), mesh.coord(axis), n)


def gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank of ``axis``'s row block, in coordinate order: the inverse
    of :func:`slice_rows`, whose docstring gives the backward."""
    n = mesh.sizes[axis]
    if n == 1:
        return x
    return _GatherRows.apply(x, mesh.get_group(axis), mesh.coord(axis), n)


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of the scalar ``x`` over every rank of ``axes``."""
    groups = [mesh.get_group(a) for a in axes if mesh.sizes[a] > 1]
    if not groups:
        return x
    n = 1
    for a in axes:
        n *= mesh.sizes[a]
    return _MeanOver.apply(x, groups, n)


def local_experts(w: torch.Tensor, n_experts: int, mesh, tp_axis: str
                  ) -> torch.Tensor:
    """This rank's ``E/tp`` experts of a stack: the stack itself when it
    holds ``E/tp`` already, else its block at the rank's model
    coordinate."""
    n_tp = mesh.sizes[tp_axis]
    e_loc = n_experts // n_tp
    if w.shape[0] == e_loc:
        return w
    if w.shape[0] != n_experts:
        raise ValueError(f"an expert stack of {w.shape[0]} for "
                         f"{n_experts} experts over {n_tp} ranks")
    j = mesh.coord(tp_axis)
    return w[j * e_loc:(j + 1) * e_loc]


def moe_ffn_sharded(params: dict, x: torch.Tensor, cfg: MoEConfig, act, *,
                    mesh, dp_axes: tuple, tp_axis: str):
    """x (T_loc, d), this rank's tokens -> (y (T_loc, d), aux ()).

    ``params["w1"/"w3"/"w2"]`` are this rank's ``E/tp`` experts (a whole
    stack is cut to them).  The shared-expert and dense-residual branches
    run on ``x`` as they are.  Every rank of the mesh must call this with
    the same shapes."""
    e, k = cfg.n_experts, cfg.top_k
    n_tp = mesh.sizes[tp_axis]
    if e % n_tp:
        raise ValueError(f"{e} experts do not split over {n_tp} ranks")
    e_loc = e // n_tp
    t_loc, d = x.shape
    c = max(4, int(t_loc * k / e * cfg.capacity_factor))
    r = route(params, x, cfg, capacity=c)
    se, keep = r["se"], r["keep"]
    tk = t_loc * k
    dev = x.device

    row = torch.where(keep, se * c + r["pos"], e * c)
    fill = torch.full((e * c + 1,), tk, dtype=torch.int64, device=dev)
    fill[row] = torch.arange(tk, device=dev)
    fill = fill[:e * c]
    src_tok = r["tok"][torch.clamp(fill, max=tk - 1)]
    buf = torch.where((fill < tk)[:, None], x[src_tok], 0)

    # ---- expert exchange: (E, c, d) -> (E/tp, tp*c, d): block j of the
    # experts goes to model rank j, which stacks its senders' slots
    bufx = exchange(buf.reshape(n_tp, e_loc, c, d), mesh, tp_axis)
    bufx = bufx.transpose(0, 1).reshape(e_loc, n_tp * c, d)
    w1, w3, w2 = (local_experts(params[n], e, mesh, tp_axis)
                  for n in ("w1", "w3", "w2"))
    h = einsum("ecd,edf->ecf", bufx, w1)
    g = einsum("ecd,edf->ecf", bufx, w3)
    h = (act(h.to(torch.float32)) * g.to(torch.float32)).to(x.dtype)
    out = einsum("ecf,efd->ecd", h, w2)

    # ---- reverse exchange: (E/tp, tp*c, d) -> (E, c, d)
    out = out.reshape(e_loc, n_tp, c, d).transpose(0, 1).contiguous()
    outx = exchange(out, mesh, tp_axis).reshape(e * c, d)

    gate_s = torch.where(keep, r["gate"], 0.0).to(x.dtype)
    vals = outx[torch.clamp(row, max=e * c - 1)] * gate_s[:, None]
    inv_order = torch.empty(tk, dtype=torch.int64, device=dev)
    inv_order[r["order"]] = torch.arange(tk, device=dev)
    y = vals[inv_order].reshape(t_loc, k, d).sum(dim=1)

    f_e = _counts(se, e).to(torch.float32) / tk
    p_e = r["probs"].mean(dim=0)
    aux_loc = cfg.router_aux_weight * e * torch.sum(f_e * p_e)
    aux = mean_over(aux_loc, mesh, tuple(dp_axes) + (tp_axis,))

    if cfg.n_shared > 0:
        y = y + _glu(x, params["shared_w1"], params["shared_w3"],
                     params["shared_w2"], act)
    if cfg.dense_residual:
        y = y + _glu(x, params["dense_w1"], params["dense_w3"],
                     params["dense_w2"], act)
    return y, aux
