"""Rule-based sharding assignment (path + shape -> spec) and the layouts
that hold a leaf as its shard on this rank.

LM scheme: FSDP over the data axes x TP over model:
  embed (V,d)           -> (model, dp)
  attn wq/wk/wv (L,d,E) -> (None, dp, model)      [heads on model]
  attn wo (L,E,d)       -> (None, model, dp)
  mlp w1/w3 (L,d,f)     -> (None, dp, model)
  mlp w2 (L,f,d)        -> (None, model, dp)
  MoE experts (L,E,d,f) -> (None, model, dp, None) [EP on model]
  norms/scalars         -> replicated
Optimizer states inherit the matching param spec (Adafactor's factored
moments drop the trailing axes).  GNN/recsys params are small ->
replicated, except huge embedding tables -> row-sharded over every axis.

The rules are the JAX reference's, as pure functions of (path, shape, dp,
model); a spec is a :class:`P`, a tuple with one entry per dimension
(None, an axis name, or a tuple of axis names, major first), normalised
as ``jax.sharding.PartitionSpec`` normalises it.  A :class:`Layout`
(mesh, spec) is the port's counterpart of a ``NamedSharding``: on a live
mesh it takes this rank's shard of a whole array and gathers a shard back
over the axes its spec names.  Paths are written as the reference writes
``jax.tree_util`` key paths: dict keys as they are, list indices as
digits, a NamedTuple's fields as ``.name``, joined by ``/``.

The ``reach_*`` layouts are the reachability index's: the query mesh's
(lanes split, index replicated) and the vertex-sharded layout's, which
``core.distributed`` runs with its own collectives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map
from .mesh import Mesh, mesh_axes


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``.  A
    one-axis tuple entry is normalised to the axis name, an empty one to
    None, as ``PartitionSpec`` does."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in np.shape(leaf)) \
        if not isinstance(leaf, torch.Tensor) else tuple(leaf.shape)


# ----------------------------------------------------------- tree paths
def _with_path(fn, tree, path: tuple):
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_with_path(fn, v, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def tree_map_with_path(fn, tree):
    """``fn(path_str, leaf)`` over a tree's leaves, rebuilt as the tree."""
    return _with_path(fn, tree, ())


# ---------------------------------------------------------------- rules
def lm_param_spec(path: str, shape: tuple, dp, model) -> P:
    nd = len(shape)
    if "embed" in path and nd == 2:                 # (V, d)
        return P(model, dp)
    if "unembed" in path:                           # (d, V)
        return P(dp, model)
    if any(s in path for s in ("router",)):         # (L, d, E)
        return P(None, dp, None)
    if any(s in path for s in ("w1", "w3")) and nd == 4:   # (L, E, d, f)
        return P(None, model, dp, None)
    if "w2" in path and nd == 4:                    # (L, E, f, d)
        return P(None, model, None, dp)
    if any(s in path for s in ("wq", "wk", "wv", "shared_w1", "shared_w3",
                               "dense_w1", "dense_w3")) and nd == 3:
        return P(None, dp, model)                   # (L, d, out)
    if any(s in path for s in ("wo", "w2", "shared_w2", "dense_w2")) \
            and nd == 3:
        return P(None, model, dp)                   # (L, in, d)
    if any(s in path for s in ("w1", "w3")) and nd == 3:
        return P(None, dp, model)
    if any(s in path for s in ("bq", "bk", "bv")) and nd == 2:
        return P(None, model)
    return P()                                       # norms, scalars


def lm_layer_param_spec(path: str, shape: tuple, dp, model) -> P:
    """Per-layer slice spec (stacked spec with the leading L axis
    dropped)."""
    spec = lm_param_spec(path, (1,) + tuple(shape), dp, model)
    return P(*tuple(spec)[1:]) if len(spec) > 0 else P()


def _shard_ok(spec: P, shape: tuple, mesh) -> P:
    """Drop axis assignments whose mesh extent does not evenly divide the
    dimension (the dry-run cells pad their shapes to multiples of 512 so
    real cells keep full sharding)."""
    sizes = mesh.sizes
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        if ax is None:
            out.append(None)
            continue
        n = int(np.prod([sizes[a] for a in _axes(ax)]))
        out.append(ax if (dim >= n and dim % n == 0) else None)
    return P(*out)


# --------------------------------------------------------------- layout
@dataclass(frozen=True)
class Layout:
    """A leaf laid out over ``mesh`` as ``spec`` says: dimension ``i`` is
    split into contiguous blocks over the axes ``spec[i]`` names (major
    axis first), replicated over the others.  ``compute`` is the spec the
    train step computes a parameter in (``make_train_step(
    state_shardings=)``): the step gathers the leaf over the axes
    ``spec`` names and ``compute`` does not; None gathers it whole."""
    mesh: Mesh
    spec: P
    compute: P | None = None

    def axes(self, dim: int) -> tuple:
        return _axes(self.spec[dim]) if dim < len(self.spec) else ()

    def parts(self, dim: int) -> int:
        sizes = self.mesh.sizes
        return int(np.prod([sizes[a] for a in self.axes(dim)]))

    def local_shape(self, shape) -> tuple:
        shape = tuple(shape)
        for d, s in enumerate(shape):
            if s % self.parts(d):
                raise ValueError(f"dim {d} of {shape} does not split "
                                 f"into {self.parts(d)} for {self.spec}")
        return tuple(s // self.parts(d) for d, s in enumerate(shape))

    def split_axes(self) -> tuple:
        """The mesh axes of more than one rank that split this leaf."""
        sizes = self.mesh.sizes
        return tuple(a for d in range(len(self.spec)) for a in self.axes(d)
                     if sizes[a] > 1)

    def _index(self, axes) -> int:
        idx = 0
        for a in axes:
            idx = idx * self.mesh.sizes[a] + self.mesh.coord(a)
        return idx

    def shard(self, full: torch.Tensor, dims=None) -> torch.Tensor:
        """This rank's block of the whole array ``full`` (a view), over the
        split dimensions ``dims`` (default all)."""
        for d in range(full.ndim) if dims is None else dims:
            n = self.parts(d)
            if n > 1:
                blk = full.shape[d] // n
                full = full.narrow(d, self._index(self.axes(d)) * blk, blk)
        return full

    def gather(self, x: torch.Tensor, dims=None) -> torch.Tensor:
        """The whole array from this rank's shard ``x``: all-gathers over
        each splitting axis (the innermost first) of the dimensions
        ``dims`` (default all)."""
        for d in range(x.ndim) if dims is None else dims:
            for a in reversed(self.axes(d)):
                n = self.mesh.sizes[a]
                if n == 1:
                    continue
                x = x.contiguous()
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x, group=self.mesh.get_group(a))
                x = torch.cat(parts, dim=d)
        return x

    def _gathered_dims(self, ndim: int) -> list:
        """The dimensions the step gathers: split in ``spec`` and not in
        ``compute`` (which keeps a dimension's axes whole or drops them)."""
        keep = self.compute or P()
        out = []
        for d in range(ndim):
            k = _axes(keep[d]) if d < len(keep) else ()
            if k and k != self.axes(d):
                raise ValueError(f"compute spec {keep} is not a part of "
                                 f"{self.spec}")
            if not k and self.parts(d) > 1:
                out.append(d)
        return out

    def to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather(x, self._gathered_dims(x.ndim))

    def from_compute(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard(x, self._gathered_dims(x.ndim))

    def compute_replicas(self) -> tuple:
        """The mesh axes (of more than one rank) over which the compute
        layout is replicated: the ranks whose gradients add up."""
        keep = {a for e in (self.compute or P()) for a in _axes(e)}
        return tuple(a for a, n in self.mesh.sizes.items()
                     if n > 1 and a not in keep)

    def psum(self, x: torch.Tensor, axes, op=None) -> torch.Tensor:
        """``x`` all-reduced (in place; summed unless ``op``) over the
        mesh ``axes``, one axis group after another."""
        for a in axes:
            if self.mesh.sizes[a] > 1:
                dist.all_reduce(x, op=op or dist.ReduceOp.SUM,
                                group=self.mesh.get_group(a))
        return x


def relayout(x: torch.Tensor, src: Layout, dst: Layout) -> torch.Tensor:
    """``x``, held as ``src`` says, as ``dst`` holds it."""
    if tuple(src.spec) == tuple(dst.spec) or not (src.split_axes()
                                                  or dst.split_axes()):
        return x
    return dst.shard(src.gather(x)).contiguous()


def shard_tree(tree: Any, layouts: Any) -> Any:
    """This rank's shard of every tensor leaf of a whole tree (a copy on
    the layout's mesh device); other leaves as they are."""
    def one(x, lay):
        if not isinstance(x, torch.Tensor):
            return x
        part = lay.shard(x)
        return torch.empty(part.shape, dtype=part.dtype,
                           device=lay.mesh.device).copy_(part)
    return tree_map(one, tree, layouts)


def gather_tree(tree: Any, layouts: Any) -> Any:
    """The whole tree from every rank's shards (every rank gets it), in
    tensors of its own: a leaf no rank splits is copied, so a later
    in-place step leaves the result as it was."""
    def one(x, lay):
        if not isinstance(x, torch.Tensor):
            return x
        return lay.gather(x) if lay.split_axes() else x.clone()
    return tree_map(one, tree, layouts)


def _layouts(tree, mesh, spec_of, compute_of=None):
    def assign(path, leaf):
        shape = _shape(leaf)
        spec = _shard_ok(spec_of(path, leaf, shape), shape, mesh)
        return Layout(mesh, spec, compute_of(path, shape, spec)
                      if compute_of else None)
    return tree_map_with_path(assign, tree)


# ------------------------------------------------------------ LM layouts
def lm_state_shardings(state_shapes: Any, mesh, *,
                       moe_impl: str = "pjit") -> Any:
    """Layouts for a TrainState-shaped tree (or a parameter tree) of
    shapes.  Under ``moe_impl="shard_map"`` the expert stacks compute
    split over the model axis (``models.transformer.moe_sharded``); every
    other leaf computes whole."""
    ax = mesh_axes(mesh)
    dp, model = ax["dp"], ax["model"]

    def spec_of(path, leaf, shape):
        spec = lm_param_spec(path, shape, dp, model)
        # factored optimizer moments: reduced rank -> trim trailing axes
        if len(spec) > len(shape):
            spec = P(*tuple(spec)[:len(shape)])
        return spec

    def compute_of(path, shape, spec):
        if moe_impl != "shard_map" or len(shape) != 4 or \
                not any(w in path for w in ("w1", "w2", "w3")):
            return None
        return P(None, spec[1])           # (L, E, ...): experts on model

    return _layouts(state_shapes, mesh, spec_of, compute_of)


def lm_batch_shardings(mesh, *, kind: str) -> Layout:
    ax = mesh_axes(mesh)
    dp = ax["dp"]
    if kind in ("train", "prefill"):
        return Layout(mesh, P(dp, None))          # tokens (B, S)
    if kind == "decode":
        return Layout(mesh, P(dp))                # token (B,)
    raise ValueError(kind)


def lm_cache_shardings(mesh, cache_shapes, *, long_context: bool) -> Any:
    """KV caches (L, B, S, KV, dh): batch->dp normally; seq->dp when B == 1
    (long-context decode shards the sequence instead)."""
    ax = mesh_axes(mesh)
    dp, model = ax["dp"], ax["model"]
    spec = P(None, None, dp, model, None) if long_context \
        else P(None, dp, None, model, None)
    return _layouts(cache_shapes, mesh, lambda path, leaf, shape: spec)


# ------------------------------------------------- reachability index
def reach_query_shardings(mesh) -> tuple:
    """The query engine's fan-out over a launch mesh: ``(query,
    replicated)`` layouts, the (Q,) batch split over every axis,
    flattened (``core.distributed.flat_query_mesh``), the label planes
    replicated."""
    return Layout(mesh, P(mesh_axes(mesh)["all"])), Layout(mesh, P())


def reach_place_index(idx, mesh):
    """A DBLIndex as the query engine over ``mesh`` serves it: whole
    (replicated) on every rank, on the mesh's device.  An index of the
    auto-partitioned scheme is gathered; a vertex-sharded one is
    refused."""
    from repro_torch.core import distributed as D
    if idx.layout.sharded:
        raise ValueError("a vertex-sharded index is served by "
                         "QueryEngine(index, vertex_mesh=mesh)")
    idx = D.gather_index(idx)
    return D.map_index(lambda x: x.to(mesh.device), idx)


def _one_axis(mesh) -> str:
    if len(mesh.axis_names) != 1:
        raise ValueError("vertex-sharded layout needs a 1-axis mesh, got "
                         f"axes {mesh.axis_names}")
    return mesh.axis_names[0]


def reach_vertex_shardings(mesh) -> tuple:
    """The vertex-sharded layout's primitives on a 1-axis mesh: ``(plane,
    vec, replicated)`` layouts, (n_cap, k) planes row-split, (n_cap,)
    per-vertex vectors split alongside them, everything else (graph,
    landmarks, scalars, query batches) replicated.
    ``core.distributed.vertex_index_shardings`` assembles the
    DBLIndex-shaped tree from them."""
    ax = _one_axis(mesh)
    return (Layout(mesh, P(ax, None)), Layout(mesh, P(ax)),
            Layout(mesh, P()))


def reach_halo_shardings(mesh) -> tuple:
    """The sparse halo's accounting arrays (``core.halo``) on a 1-axis
    mesh: ``(pair, replicated)`` layouts, the (d, d) per-(sender,
    receiver) count matrices row-split (each shard owns its sender row),
    the fixpoint scalars replicated."""
    ax = _one_axis(mesh)
    return Layout(mesh, P(ax, None)), Layout(mesh, P())


# ------------------------------------------------------- GNN and recsys
def gnn_shardings(state_shapes: Any, mesh) -> Any:
    """GNN params are small: replicate everything (grads all-reduce)."""
    return _layouts(state_shapes, mesh, lambda path, leaf, shape: P())


def gnn_batch_shardings(batch_shapes: Any, mesh, *, axes: str = "all"
                        ) -> Any:
    """Node/edge/triplet arrays: leading dim sharded over every axis
    (axes="all") or the data axes only (axes="dp")."""
    ax = mesh_axes(mesh)["all"] if axes == "all" else mesh_axes(mesh)["dp"]

    def spec_of(path, leaf, shape):
        if not shape:
            return P()
        if path.endswith("edge_index"):                # (2, m)
            return P(None, ax)
        return P(ax, *(None,) * (len(shape) - 1))

    return _layouts(batch_shapes, mesh, spec_of)


def recsys_state_shardings(state_shapes: Any, mesh) -> Any:
    ax = mesh_axes(mesh)["all"]

    def spec_of(path, leaf, shape):
        if "item_embed" in path and shape:
            return P(ax, *(None,) * (len(shape) - 1))  # row-sharded table
        return P()

    return _layouts(state_shapes, mesh, spec_of)


def recsys_batch_shardings(batch_shapes: Any, mesh) -> Any:
    dp = mesh_axes(mesh)["dp"]

    def spec_of(path, leaf, shape):
        if path.endswith("negatives") or path.endswith("candidates") \
                or not shape:
            return P()                                 # shared across batch
        return P(dp, *(None,) * (len(shape) - 1))

    return _layouts(batch_shapes, mesh, spec_of)
