"""Dry-run cell builders: (arch x shape x mesh) -> (fn, shape trees,
layouts, meta).

A cell's arguments are *shape trees*, the port's counterpart of
``jax.eval_shape``: the model is built on the meta device (no draws), so
every leaf has its shape and dtype and no storage (``step`` and ``rng``
of a train state are host numpy values, as in any state).  Beside each
argument goes its tree of ``sharding.Layout``s, whose local shapes give
the bytes each rank would hold (launch/dryrun.py).  ``fn`` is the step or
forward itself, runnable on a live mesh with real shards.  ``meta``
carries the reference's analytic MODEL_FLOPS and shape bookkeeping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES,
                                        LONG_CONTEXT_OK, REC_SHAPES)
from repro_torch.core._threefry import seed_key
from repro_torch.models.params import bound_call, params_tree
from repro_torch.train.loop import init_state, lm_loss, make_train_step
from repro_torch.train.optim import cosine_schedule
from . import sharding as SH
from .mesh import mesh_axes

META = torch.device("meta")


@dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple            # shape trees
    layouts: tuple         # one tree of Layouts per argument
    donate: tuple          # argnums to donate
    meta: dict


class SkipCell(Exception):
    pass


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------- hooks
def lm_constrain(cfg, mesh) -> Callable:
    """The layout hook of an LM cell (``Transformer``'s ``constrain``).

    Only ``"moe_call"`` acts: under ``cfg.moe_impl == "shard_map"`` it
    runs ``moe_ffn_sharded``.  The ranks of a model group hold the same
    data block of tokens, so rank j of the group takes the j-th of
    ``n_tp`` slices of ``flat`` (``moe_sharded.slice_rows``), runs the
    sharded MoE on it and gathers ``y`` back over the model axis
    (``gather_rows``): the gather's backward keeps the rank's own slice
    (times ``n_tp``), and the slice's averages the slices' gradients over
    the group, so every gradient outside the MoE stays alike within the
    group, as ``make_train_step(state_shardings=)`` takes it.  When the
    local token count
    does not divide by ``n_tp`` the hook returns its argument and the
    model runs the local ``moe_ffn``, which needs the whole expert stack.

    The reference's other kinds (``layer_params``, ``residual``,
    ``logits``, ``moe_tokens``, ``moe_buf``) only pin placements for its
    compiler; every rank here computes its own layout explicitly, so they
    are the identity."""
    from repro_torch.models.transformer.model import _act
    from repro_torch.models.transformer.moe_sharded import (
        gather_rows, moe_ffn_sharded, slice_rows)
    dp = mesh_axes(mesh)["dp"]
    n_tp = mesh.sizes.get("model", 1)

    def constrain(x, kind):
        if kind != "moe_call" or cfg.moe is None \
                or cfg.moe_impl != "shard_map":
            return x
        mp, flat = x
        t = flat.shape[0]
        if t % n_tp:
            if mp["w1"].shape[0] != cfg.moe.n_experts:
                raise ValueError(
                    f"{t} tokens do not split over {n_tp} model ranks, and "
                    "the local MoE needs the whole expert stack")
            return x
        y, aux = moe_ffn_sharded(mp, slice_rows(flat, mesh, "model"),
                                 cfg.moe, _act(cfg.act), mesh=mesh,
                                 dp_axes=dp, tp_axis="model")
        return gather_rows(y, mesh, "model"), aux

    return constrain


# ----------------------------------------------------------------- LM cells
def _lm_model_flops(cfg, tokens: int, seq: int, *, train: bool,
                    decode: bool = False) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D for
    inference forward, plus the attention term (local layers see
    min(seq, window) keys)."""
    n_act = cfg.params_active
    mult = 6 if train else 2
    flops = mult * n_act * tokens
    # attention scores+values: 2 matmuls * 2 flops = 12 per (q, k) pair bwd-incl
    att_mult = 12 if train else 4
    if cfg.layer_pattern == "local_global":
        w = min(cfg.window, seq)
        kv_len = (seq + w) / 2 if not decode else (seq + w) / 2
    else:
        kv_len = seq
    if decode:
        flops += att_mult * cfg.n_layers * cfg.n_heads * cfg.d_head \
            * tokens * kv_len
    else:
        flops += att_mult * cfg.n_layers * cfg.n_heads * cfg.d_head \
            * tokens * kv_len / 2  # causal halves the pairs
    return float(flops)


def build_lm_cell(arch: str, shape_name: str, mesh) -> Cell:
    cfg, _, family = get_config(arch)
    assert family == "lm"
    shape = LM_SHAPES[shape_name]
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        raise SkipCell(
            f"{arch} is pure full-attention; long_500k needs sub-quadratic "
            "attention state")
    from repro_torch.models.transformer.model import Transformer, init_cache

    ax = mesh_axes(mesh)
    dp = ax["dp"]
    b, s = shape.global_batch, shape.seq_len
    n_dp = int(np.prod([mesh.sizes[a] for a in dp]))
    model = Transformer(cfg, device=META)
    constrain = lm_constrain(cfg, mesh)
    params = model.params
    flat_kw = dict(params=cfg.params_dense, params_active=cfg.params_active)

    def _ok(dim, n):
        return dim >= n and dim % n == 0

    if shape.kind == "train":
        state = init_state(seed_key(0), params, cfg.optimizer)
        state_sh = SH.lm_state_shardings(state, mesh, moe_impl=cfg.moe_impl)
        batch = {"tokens": _meta((b, s), torch.int32),
                 "targets": _meta((b, s), torch.int32)}
        tok_sh = SH.lm_batch_shardings(mesh, kind="train")
        step = make_train_step(
            lm_loss(model, constrain), optimizer=cfg.optimizer,
            lr_schedule=cosine_schedule(3e-4, 100, 10_000), jit=False,
            state_shardings=state_sh)
        meta = {"model_flops": _lm_model_flops(cfg, b * s, s, train=True),
                "tokens": b * s, **flat_kw}
        return Cell(arch, shape_name, step, (state, batch),
                    (state_sh, {"tokens": tok_sh, "targets": tok_sh}),
                    donate=(0,), meta=meta)

    params_sh = SH.lm_state_shardings(params, mesh, moe_impl=cfg.moe_impl)
    if shape.kind == "prefill":
        prefill = bound_call(model, "prefill", s_cache=s,
                             constrain=constrain)
        meta = {"model_flops": _lm_model_flops(cfg, b * s, s, train=False),
                "tokens": b * s, **flat_kw}
        return Cell(arch, shape_name, prefill,
                    (params, _meta((b, s), torch.int32)),
                    (params_sh, SH.lm_batch_shardings(mesh, kind="prefill")),
                    donate=(), meta=meta)

    # decode: one new token against an s-long cache
    cache = init_cache(cfg, b, s, device=META)
    cache_sh = SH.lm_cache_shardings(mesh, cache, long_context=b == 1)
    tok_sh = (SH.lm_batch_shardings(mesh, kind="decode") if _ok(b, n_dp)
              else SH.Layout(mesh, SH.P()))  # B=1 long-context: replicate
    meta = {"model_flops": _lm_model_flops(cfg, b, s, train=False,
                                           decode=True),
            "tokens": b, **flat_kw,
            "kv_cache_bytes": sum(int(np.prod(c.shape)) * 2
                                  for c in cache.values())}
    return Cell(arch, shape_name, bound_call(model, "decode_step"),
                (params, cache, _meta((b,), torch.int32),
                 _meta((), torch.int32)),
                (params_sh, cache_sh, tok_sh, SH.Layout(mesh, SH.P())),
                donate=(1,), meta=meta)


# ---------------------------------------------------------------- GNN cells
_GNN_CLASSES = {"full_graph_sm": 7, "ogb_products": 47, "minibatch_lg": 41,
                "molecule": 16}


def _gnn_class(family: str):
    from repro_torch.models.gnn import dimenet, mace, nequip, pna
    return {"pna": pna.PNA, "nequip": nequip.NequIP, "mace": mace.MACE,
            "dimenet": dimenet.DimeNet}[family]


def _shapes_of(tree):
    """A tree of tensors as meta tensors of the same shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _shapes_of(v) for k, v in tree.items()}
    return _meta(tree.shape, tree.dtype)


def build_gnn_cell(arch: str, shape_name: str, mesh) -> Cell:
    cfg, _, family = get_config(arch)
    assert family == "gnn"
    shape = GNN_SHAPES[shape_name]
    cfg = cfg.scaled(n_classes=_GNN_CLASSES[shape_name])

    def pad512(x: int) -> int:
        return ((x + 511) // 512) * 512

    if shape.kind == "minibatch":
        seeds = shape.batch_nodes
        e0 = seeds * shape.fanout[0]
        e1 = e0 * shape.fanout[1]
        n = seeds + e0 + e1
        m = e0 + e1
    elif shape.kind == "batched":
        n = shape.batch_graphs * shape.n_nodes
        m = shape.batch_graphs * shape.n_edges
    else:
        n, m = shape.n_nodes, shape.n_edges
    n_orig, m_orig = n, m
    # pad to even 512-way tiling (padded nodes/edges are masked by
    # edge_valid / routed to the dump segment; see sharding._shard_ok)
    n, m = pad512(n), pad512(m)
    d_feat = shape.d_feat
    needs_geom = cfg.family in ("nequip", "mace", "dimenet")
    n_trip = pad512(4 * m) if cfg.family == "dimenet" else 0

    batch: dict[str, Any] = {
        "edge_index": _meta((2, m), torch.int32),
        "edge_valid": _meta((m,), torch.bool),
        "species": _meta((n,), torch.int32),
    }
    if d_feat:
        batch["node_feat"] = _meta((n, d_feat), torch.float32)
    if needs_geom:
        batch["positions"] = _meta((n, 3), torch.float32)
    if n_trip:
        batch["triplet_in"] = _meta((n_trip,), torch.int32)
        batch["triplet_out"] = _meta((n_trip,), torch.int32)
        batch["triplet_valid"] = _meta((n_trip,), torch.bool)
    if shape.kind == "batched":
        batch["graph_ids"] = _meta((n,), torch.int32)
        batch["energy_target"] = _meta((shape.batch_graphs,), torch.float32)
    else:
        batch["labels"] = _meta((n,), torch.int32)

    # GNN parameters are small: the model is built on the host, then
    # only its shapes are kept
    model = _gnn_class(cfg.family)(cfg, d_feat)
    state = init_state(seed_key(0), _shapes_of(params_tree(model)), "adamw")
    state_sh = SH.gnn_shardings(state, mesh)
    batch_sh = SH.gnn_batch_shardings(batch, mesh, axes=cfg.shard_axes)
    loss_call = bound_call(model, "loss_fn")

    def loss(p, bt, r):
        if shape.kind == "batched":
            bt = dict(bt)
            bt["n_graphs"] = shape.batch_graphs
        return loss_call(p, bt)

    step = make_train_step(loss, optimizer="adamw",
                           lr_schedule=cosine_schedule(1e-3, 10, 1000),
                           jit=False, state_shardings=state_sh)
    # analytic flops: message MLPs over edges dominate for pna/dimenet;
    # tensor products over edges for nequip/mace
    d = cfg.d_hidden
    if cfg.family == "pna":
        mf = 6 * m * (2 * d * d + d * d) + 6 * n * (13 * d * d)
    elif cfg.family == "dimenet":
        mf = cfg.n_blocks * (6 * n_trip * cfg.n_bilinear * d * d
                             + 6 * m * 3 * d * d)
    else:
        n_paths = 19 if cfg.l_max == 2 else 4
        layers = cfg.n_layers
        mf = layers * 6 * m * n_paths * d * 25  # CG contract ~ (2l+1)^2 ops
        mf += layers * 6 * n * (cfg.l_max + 1) * d * d * 5
        if cfg.family == "mace":
            mf += layers * 6 * n * 19 * d * 125  # B2/B3 tensor powers
    meta = {"model_flops": float(mf), "n_nodes": n_orig, "n_edges": m_orig,
            "n_nodes_padded": n, "n_edges_padded": m,
            "params": sum(p.numel() for p in model.parameters())}
    return Cell(arch, shape_name, step, (state, batch), (state_sh, batch_sh),
                donate=(0,), meta=meta)


# -------------------------------------------------------------- RecSys cells
def build_recsys_cell(arch: str, shape_name: str, mesh) -> Cell:
    cfg, _, family = get_config(arch)
    assert family == "recsys"
    from repro_torch.models.recsys.mind import MIND
    shape = REC_SHAPES[shape_name]
    d = cfg.embed_dim
    model = MIND(cfg, device=META)
    params = params_tree(model)

    if shape.kind == "train":
        b = shape.batch
        state = init_state(seed_key(0), params, "adamw")
        state_sh = SH.recsys_state_shardings(state, mesh)
        batch = {
            "hist": _meta((b, cfg.hist_len), torch.int32),
            "hist_mask": _meta((b, cfg.hist_len), torch.float32),
            "target": _meta((b,), torch.int32),
            "negatives": _meta((cfg.n_neg,), torch.int32),
        }
        batch_sh = SH.recsys_batch_shardings(batch, mesh)
        loss_call = bound_call(model, "loss_fn")
        step = make_train_step(lambda p, bt, r: loss_call(p, bt),
                               optimizer="adamw",
                               lr_schedule=cosine_schedule(1e-3, 100, 10000),
                               jit=False, state_shardings=state_sh)
        mf = 6 * b * (cfg.hist_len * d * d                 # S-matrix
                      + cfg.capsule_iters * cfg.hist_len
                      * cfg.n_interests * d * 2
                      + (cfg.n_neg + 1) * d)
        meta = {"model_flops": float(mf), "batch": b,
                "table_bytes": cfg.n_items * d * 4}
        return Cell(arch, shape_name, step, (state, batch),
                    (state_sh, batch_sh), donate=(0,), meta=meta)

    params_sh = SH.recsys_state_shardings(params, mesh)
    ax = mesh_axes(mesh)
    dp = ax["dp"]

    if shape.kind == "serve":
        b = shape.batch
        row_sh = SH.Layout(mesh, SH.P(dp, None))
        mf = 2 * b * (cfg.hist_len * d * d
                      + cfg.capsule_iters * cfg.hist_len * cfg.n_interests
                      * d * 2)
        meta = {"model_flops": float(mf), "batch": b,
                "table_bytes": cfg.n_items * d * 4}
        return Cell(arch, shape_name, bound_call(model, "interests"),
                    (params, _meta((b, cfg.hist_len), torch.int32),
                     _meta((b, cfg.hist_len), torch.float32)),
                    (params_sh, row_sh, row_sh), donate=(), meta=meta)

    # retrieval: 1 user x n_candidates (padded to even 512-way tiling)
    b, c = shape.batch, ((shape.n_candidates + 511) // 512) * 512
    repl = SH.Layout(mesh, SH.P())
    mf = 2 * b * cfg.n_interests * c * d
    meta = {"model_flops": float(mf), "batch": b, "candidates": c,
            "table_bytes": cfg.n_items * d * 4}
    return Cell(arch, shape_name, bound_call(model, "retrieval_scores"),
                (params, _meta((b, cfg.hist_len), torch.int32),
                 _meta((b, cfg.hist_len), torch.float32),
                 _meta((c,), torch.int32)),
                (params_sh, repl, repl, SH.Layout(mesh, SH.P(ax["all"]))),
                donate=(), meta=meta)


# -------------------------------------------------------------------- table
def build_cell(arch: str, shape_name: str, mesh) -> Cell:
    _, _, family = get_config(arch)
    builder = {"lm": build_lm_cell, "gnn": build_gnn_cell,
               "recsys": build_recsys_cell}[family]
    return builder(arch, shape_name, mesh)


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import ARCH_IDS
    out = []
    for arch in ARCH_IDS:
        _, _, family = get_config(arch)
        shapes = {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                  "recsys": REC_SHAPES}[family]
        for s in shapes:
            out.append((arch, s))
    return out


def cell_leaves(cell: Cell) -> list:
    """(path, leaf, layout) of every argument leaf, the argument's index
    leading the path (``"0/.params/embed"``)."""
    out = []
    for i, (arg, lays) in enumerate(zip(cell.args, cell.layouts)):
        leaves = []
        SH.tree_map_with_path(lambda p, x: leaves.append((p, x)), arg)
        if isinstance(lays, SH.Layout):
            flat = [lays] * len(leaves)
        else:
            flat = []
            SH.tree_map_with_path(lambda p, x: flat.append(x), lays)
        out += [(f"{i}/{p}" if p else str(i), x, lay)
                for (p, x), lay in zip(leaves, flat)]
    return out


def leaf_bytes(leaf, layout) -> int:
    """The bytes of ``leaf``'s shard on one rank under ``layout``."""
    if isinstance(leaf, torch.Tensor):
        item = leaf.element_size()
    else:
        item = np.asarray(leaf).dtype.itemsize
    return int(np.prod(layout.local_shape(SH._shape(leaf)))) * item

