"""Sharded DBL over ``torch.distributed`` (SPMD): two schemes.

**Auto-partitioned scheme** (the reference's "GSPMD scheme";
:func:`index_shardings`, :func:`shard_index`, :func:`distributed_build`,
:func:`distributed_insert`): on a launch mesh (``launch.mesh.Mesh``),
every array leaf of the index is split into contiguous blocks over all
of the mesh's axes, flattened (``launch.sharding.Layout``): the plane
rows, the packed words, the leaf masks and the edge arrays.  The index
records its mesh (``DBLIndex.scheme``) and stays in that layout across
insert batches.  Where the reference's partitioner materializes the
exchanges the unmodified core code needs, this module makes them
explicit: a fixpoint gathers the planes once, each rank relaxes its own
block of the edges against the whole plane (``propagate``'s
``combine``), and one ``all_reduce`` a round (MAX on the uint8 OR planes,
MIN on the int32 rank planes) merges the ranks' planes; every rank tests
convergence on the merged plane, and keeps its rows at the end.  The
query path gathers the packed rows.  :func:`shard_index` re-places an
index onto a mesh of another shape (elastic).

**Vertex-sharded scheme** (the rest of this module).  One process per
shard runs the same host program.  Label planes (bool and
packed, and the "il" rank planes) are row-partitioned: rank ``r`` of ``d``
holds rows ``[r * n_loc, (r + 1) * n_loc)``.  The graph, the landmarks,
the leaf masks, the epochs and the host halves of the shard plans are
replicated: every rank computes them from the same inputs, so nothing is
broadcast.  Fixpoints move only boundary frontier rows
(``planes.halo_propagate``); insert seeding moves only the b inserted
edges' rows (``planes.sharded_seed_scatter``).  Results are bitwise equal
to the replicated ``DBLIndex``.

    dist.init_process_group("gloo", init_method=..., rank=r, world_size=d)
    mesh = vertex_mesh(device="cpu")              # "cuda:<rank>" by default
    idx, plan = build_vertex_sharded(g, mesh, n_cap=n)
    idx, plan, sat = insert_vertex_sharded(idx, plan, src, dst)
    idx = idx.delete_edges(src, dst)
    idx, plan, info = rebuild_vertex_sharded(idx, plan, mode="delta")

and the auto-partitioned one:

    mesh = launch.mesh.make_mesh_compat((2, 2), ("data", "model"))
    idx = distributed_build(g, mesh, n_cap=n)
    idx = distributed_insert(idx, mesh, src, dst)
    idx = shard_index(idx, make_mesh_compat((4,), ("data",)))

Every rank must call these with the same arguments in the same order: a
rank that skips a call leaves the others blocked in a collective.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels.dbl_query.ops import verdicts_device
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (P, Layout, reach_vertex_shardings,
                                         relayout)
from . import families as F
from . import graph as G
from . import labels as L
from . import planes as PL
from . import query as Q
from . import select as S
from . import update as U
from .dbl import (DBLIndex, LabelSaturationError,  # noqa: F401
                  LabelSaturationWarning, _PLANES, _check_mode, _surface)
from .graph import Graph
from .interval import rank_plane
from .propagate import check_halo_mode, check_plane_repr


#: the axis a query mesh splits: the lanes of a query batch
QUERY_AXIS = "query"


@dataclass(frozen=True)
class VertexMesh:
    """A 1-axis mesh: this process's place in a process group.  ``axis``
    says what the ranks split: the vertex rows of the label planes
    (:func:`vertex_mesh`) or the lanes of a query batch, labels
    replicated (:func:`query_mesh`)."""
    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = PL.VERTEX_AXIS


def _mesh_over(name: str, shards, device, group, axis: str) -> VertexMesh:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{name} needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) in every rank first")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if shards is not None and shards != size:
        raise ValueError(f"the group has {size} ranks, not {shards}: make "
                         "a group of that size with dist.new_group and "
                         "pass group=")
    if device is None:
        resolve_device(None)                  # raises without CUDA
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    return VertexMesh(group, dist.get_rank(group), size,
                      resolve_device(device), axis)


def vertex_mesh(shards: int | None = None, *, device=None,
                group=None) -> VertexMesh:
    """The vertex mesh over a process group the caller (or a launcher)
    has initialized: ``group`` (default the whole world) with ``shards``
    ranks (``None``: all of them).  The device defaults to
    ``cuda:<global rank % device count>`` and raises without CUDA; pass
    ``device="cpu"`` for the CPU (gloo)."""
    return _mesh_over("vertex_mesh", shards, device, group, PL.VERTEX_AXIS)


def query_mesh(shards: int | None = None, *, device=None,
               group=None) -> VertexMesh:
    """The query-axis mesh: the same :class:`VertexMesh` handle over the
    same kind of process group, with ``axis == "query"``.  Every rank
    holds the whole replicated index; a batch's lanes are split into one
    contiguous block a rank (:func:`distributed_label_verdicts`,
    ``QueryEngine(mesh=...)``).  Arguments as in :func:`vertex_mesh`."""
    return _mesh_over("query_mesh", shards, device, group, QUERY_AXIS)


def fan_out(mesh: VertexMesh, verdicts, u: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """``verdicts(u_blk, v_blk)`` on this rank's contiguous block of the
    lanes, then one all-gather into a (Q,) tensor on every rank.  The lanes
    are padded to a multiple of the mesh size with self-queries on vertex
    0, which are cut off again."""
    q, d = u.shape[0], mesh.size
    blk = -(-q // d)
    pad = blk * d - q
    if pad:
        zeros = torch.zeros(pad, dtype=u.dtype, device=u.device)
        u, v = torch.cat([u, zeros]), torch.cat([v, zeros])
    lo = mesh.rank * blk
    part = verdicts(u[lo:lo + blk], v[lo:lo + blk]).contiguous()
    out = torch.empty(blk * d, dtype=part.dtype, device=part.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, part, group=mesh.group)
    return out[:q]


def flat_rank(mesh: Mesh) -> int:
    """This rank's index on a launch mesh's axes, flattened row-major: its
    block of a leaf split over every axis.  ``make_mesh_compat`` lays the
    world out row-major, so it is the global rank."""
    return int(np.ravel_multi_index(mesh.coords, mesh.shape))


def _world_group(mesh: Mesh):
    """The process group of all of a live launch mesh's ranks: the whole
    world, which ``make_mesh_compat`` covers."""
    if mesh.abstract:
        raise ValueError("an abstract mesh has no ranks")
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"a {mesh.shape} mesh covers {mesh.size} ranks; "
                         f"the world has {world}")
    return dist.group.WORLD


def flat_query_mesh(mesh: Mesh) -> VertexMesh:
    """The query mesh that splits lanes over every axis of a launch mesh,
    flattened: the reference's ``reach_query_shardings``."""
    return VertexMesh(_world_group(mesh), flat_rank(mesh), mesh.size,
                      mesh.device, QUERY_AXIS)


def distributed_label_verdicts(idx: DBLIndex, mesh, u, v) -> torch.Tensor:
    """Label verdicts (``DBLIndex.label_verdicts``) with the query batch
    split over a mesh: a query mesh (:func:`query_mesh`) or a launch mesh
    (split over all of its axes, flattened).  Each rank runs the verdict
    kernel (its plain version on the CPU) on its block of the lanes
    against the whole packed rows, and one all-gather gives every rank the
    (Q,) int8 verdicts.  An index of the auto-partitioned scheme gathers
    its packed rows (and interval planes) first: the gather the
    reference's partitioner makes on the query path."""
    if idx.layout.sharded:
        raise ValueError("a query mesh serves a replicated index; a "
                         "vertex-sharded one is served by "
                         "QueryEngine(index, vertex_mesh=mesh)")
    if isinstance(mesh, Mesh):
        mesh = flat_query_mesh(mesh)
    packed, il = idx.packed, idx.il
    if idx.scheme is not None:
        lays = index_shardings(idx.scheme, il=il is not None)
        packed = Q.PackedLabels(*(lay.gather(w) for w, lay in
                                  zip(packed, lays.packed)))
        if il is not None:
            il = (lays.il_in.gather(il[0]), lays.il_out.gather(il[1]))
    dev = idx.device
    u = torch.as_tensor(np.asarray(u, np.int32)).to(dev)
    v = torch.as_tensor(np.asarray(v, np.int32)).to(dev)

    def verdicts(a, b):
        fresh = torch.full(a.shape, Q.FRESH_CUT, dtype=torch.int32,
                           device=dev)
        return verdicts_device(packed, a, b, fresh, 0, None, None, il,
                               out_dtype=torch.int8)
    return fan_out(mesh, verdicts, u, v)


# ===================================================================
# The auto-partitioned scheme (the reference's GSPMD scheme)
# ===================================================================
@dataclass
class SchemeTraffic:
    """The collectives of the auto-partitioned lifecycle: the merging
    ``all_reduce`` of every fixpoint round and the gathers of the planes
    at an insert's entry, in calls and bytes (each rank's buffer)."""
    all_reduce_calls: int = 0
    all_reduce_bytes: int = 0
    all_gather_calls: int = 0
    all_gather_bytes: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class _Combine:
    """``propagate``'s ``combine`` over a launch mesh's ranks: one
    ``all_reduce`` of the whole plane, MAX for the uint8 OR planes (a bool
    plane goes as its uint8 view: NCCL takes no bool), MIN for the int32
    rank planes."""

    def __init__(self, mesh: Mesh, traffic: SchemeTraffic | None):
        self.group = _world_group(mesh)
        self.traffic = traffic

    def __call__(self, plane: torch.Tensor, monoid: str) -> None:
        buf = plane.view(torch.uint8) if plane.dtype == torch.bool \
            else plane
        op = dist.ReduceOp.MAX if monoid == "or" else dist.ReduceOp.MIN
        dist.all_reduce(buf, op=op, group=self.group)
        if self.traffic is not None:
            self.traffic.all_reduce_calls += 1
            self.traffic.all_reduce_bytes += buf.numel() * buf.element_size()


def index_shardings(mesh: Mesh, *, il: bool = False) -> DBLIndex:
    """A DBLIndex-shaped tree of ``launch.sharding.Layout``s: the bool,
    packed and ``il`` planes (rows first) ``P(all_axes, None)``, the
    (n_cap,) and (m_cap,) vectors ``P(all_axes)`` (split data-major over
    the axes, flattened), scalars and the landmarks ``P()``.  ``il=True``
    adds the interval family's leaves; the default keeps them None, so
    the tree matches a default-families index."""
    ax = tuple(mesh.axis_names)
    vec = Layout(mesh, P(ax))
    plane = Layout(mesh, P(ax, None))
    scal = Layout(mesh, P())
    g = Graph(src=vec, dst=vec, n=scal, m=scal, del_at=vec, del_epoch=scal)
    packed = Q.PackedLabels(plane, plane, plane, plane)
    return DBLIndex(graph=g, landmarks=scal, dl_in=plane, dl_out=plane,
                    bl_in=plane, bl_out=plane, packed=packed,
                    bl_sources=vec, bl_sinks=vec, epoch=scal,
                    label_del_epoch=scal, saturated=scal,
                    il_in=plane if il else None,
                    il_out=plane if il else None,
                    il_seed=scal if il else None)


def map_index(fn, idx: DBLIndex, *trees: DBLIndex, **kw) -> DBLIndex:
    """``fn(tensor, *leaves)`` over every tensor leaf of ``idx``, with the
    same leaf of each of ``trees`` (layout trees, say); host leaves
    (``m``, the epochs, the flags) as they are; ``kw`` replaces other
    fields."""
    def each(get):
        return fn(get(idx), *(get(t) for t in trees))
    graph = replace(idx.graph, **{
        f: each(lambda t, f=f: getattr(t.graph, f))
        for f in ("src", "dst", "n", "del_at")})
    fields = ["landmarks", *_PLANES, "bl_sources", "bl_sinks"]
    if idx.il_in is not None:
        fields += ["il_in", "il_out"]
    out = {f: each(lambda t, f=f: getattr(t, f)) for f in fields}
    packed = Q.PackedLabels(*(each(lambda t, f=f: getattr(t.packed, f))
                              for f in _PLANES))
    return replace(idx, graph=graph, packed=packed, **out, **kw)


def _block(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """This rank's block of a whole leaf, a tensor of its own on the
    mesh's device; raises when the leaf does not split evenly."""
    lay.local_shape(x.shape)
    part = lay.shard(x)
    return torch.empty(part.shape, dtype=part.dtype,
                       device=lay.mesh.device).copy_(part)


def shard_index(idx: DBLIndex, mesh: Mesh) -> DBLIndex:
    """This rank's block of every leaf of ``idx`` in
    ``index_shardings(mesh)``, on ``mesh.device``, recorded as
    ``scheme=mesh``.  ``idx`` is whole (replicated) or already in the
    scheme on another mesh: then each leaf is gathered over the old
    layout and sliced for the new one (``relayout``), the elastic
    re-placement.  A vertex-sharded index is refused."""
    if idx.layout.sharded:
        raise ValueError("shard_index takes a replicated index or one of "
                         "the auto-partitioned scheme; a vertex-sharded "
                         "one keeps its own layout")
    lays = index_shardings(mesh, il=idx.il_in is not None)
    if idx.scheme is None:
        return map_index(_block, idx, lays, scheme=mesh)
    old = index_shardings(idx.scheme, il=idx.il_in is not None)
    return map_index(lambda x, src, dst: relayout(x, src, dst).contiguous()
                     .to(mesh.device), idx, old, lays, scheme=mesh)


def gather_index(idx: DBLIndex) -> DBLIndex:
    """The whole index from an auto-partitioned one, on every rank (one
    all-gather a split leaf)."""
    if idx.scheme is None:
        return idx
    lays = index_shardings(idx.scheme, il=idx.il_in is not None)
    return map_index(lambda x, lay: lay.gather(x) if lay.split_axes()
                      else x, idx, lays, scheme=None)


def _edge_view(g: Graph, mesh: Mesh) -> Graph:
    """This rank's block of the edge slots as a graph of its own: ``m``
    counts the block's slots below the global high-water mark, so
    ``graph.edge_mask`` and ``graph.delete_edges`` read it as they read a
    whole graph."""
    blk = g.src.shape[0]
    lo = flat_rank(mesh) * blk
    return replace(g, m=min(max(g.m - lo, 0), blk))


def _insert_block(g: Graph, mesh: Mesh, ns: torch.Tensor,
                  nd: torch.Tensor) -> Graph:
    """``graph.insert_edges`` on this rank's block of the edge slots: the
    batch goes to global slots ``[m, m + b)``, each rank writes those in
    its block, and ``m`` and ``n`` move on every rank."""
    blk = g.src.shape[0]
    lo = flat_rank(mesh) * blk
    slots = g.m + torch.arange(ns.shape[0], device=g.device)
    keep = (slots >= lo) & (slots < lo + blk)
    src, dst = g.src.clone(), g.dst.clone()
    src[slots[keep] - lo] = ns[keep]
    dst[slots[keep] - lo] = nd[keep]
    n = g.n
    if ns.numel():
        nmax = torch.maximum(ns.max(), nd.max()) + 1
        n = torch.maximum(n, nmax.to(torch.int32))
    return replace(g, src=src, dst=dst, n=n, m=g.m + int(ns.shape[0]))


def distributed_build(g: Graph, mesh: Mesh, *, n_cap: int, k: int = 64,
                      k_prime: int = 64, selection: str = "product",
                      leaf_r: int = 0, max_iters: int = 256,
                      check: str = "warn", plane_repr: str = "bool",
                      families=F.DEFAULT_FAMILIES,
                      il_dim: int = F.DEFAULT_IL_DIM, il_seed: int = 0,
                      rounds=None, traffic: SchemeTraffic | None = None
                      ) -> DBLIndex:
    """Alg 1 in the auto-partitioned scheme, bitwise equal to
    ``DBLIndex.build``.  The landmarks and the leaf masks come from the
    whole graph ``g`` every rank is given; each fixpoint relaxes this
    rank's block of the edges against the whole plane and merges the
    planes with one ``all_reduce`` a round; each rank keeps its rows and
    packs its words.  The rounds run on bool planes whatever
    ``plane_repr`` says (the planes are equal either way).  ``rounds``, a
    list, gets each fixpoint's ``iters``; ``traffic`` (a
    :class:`SchemeTraffic`) counts the collectives."""
    _check_mode(check)
    check_plane_repr(plane_repr)
    plugin_fams = F.plugins(families)
    lays = index_shardings(mesh, il=bool(plugin_fams))
    g = g.to(mesh.device)
    landmarks = S.select_landmarks(g, n_cap=n_cap, k=k, method=selection)
    sources, sinks = S.leaf_masks(g, n_cap=n_cap, leaf_r=leaf_r)
    g_blk = replace(g, src=_block(g.src, lays.graph.src),
                    dst=_block(g.dst, lays.graph.dst),
                    del_at=_block(g.del_at, lays.graph.del_at))
    view = _edge_view(g_blk, mesh)
    comb = _Combine(mesh, traffic)
    dl_in, dl_out, it_dl = L.build_dl(view, landmarks, n_cap=n_cap, k=k,
                                      max_iters=max_iters, combine=comb)
    bl_in, bl_out, it_bl = L.build_bl(view, sources, sinks, n_cap=n_cap,
                                      k_prime=k_prime, max_iters=max_iters,
                                      combine=comb)
    iters = it_dl + it_bl
    il_kw = {}
    for fam in plugin_fams:
        p_in, p_out, it_f = fam.build(view, n_cap=n_cap, dim=il_dim,
                                      seed=il_seed, max_iters=max_iters,
                                      combine=comb)
        il_kw = dict(il_in=_block(p_in, lays.il_in),
                     il_out=_block(p_out, lays.il_out), il_seed=int(il_seed))
        iters = iters + it_f
    _note(rounds, *iters)
    sat = U.saturated(iters, max_iters)
    _surface(sat, check, max_iters)
    rows = [_block(x, lays.dl_in) for x in (dl_in, dl_out, bl_in, bl_out)]
    return DBLIndex(g_blk, landmarks, *rows, Q.pack_labels(*rows),
                    _block(sources, lays.bl_sources),
                    _block(sinks, lays.bl_sinks), epoch=0,
                    label_del_epoch=g.del_epoch, saturated=sat,
                    scheme=mesh, **il_kw)


def distributed_insert(idx: DBLIndex, mesh: Mesh, new_src, new_dst, *,
                       max_iters: int = 256, check: str = "warn",
                       rounds=None, traffic: SchemeTraffic | None = None
                       ) -> DBLIndex:
    """Batched Alg-3 insert in the auto-partitioned scheme, bitwise equal
    to ``DBLIndex.insert_edges``; the index comes out in
    ``index_shardings(mesh)`` (an index on another mesh, or a whole one,
    is placed there first), with no host round trip of the planes.  The
    planes are gathered once; the seeding runs on the whole planes, each
    fixpoint round relaxes this rank's block of the edges and one
    ``all_reduce`` merges the planes (``update.update_inserted``, and the
    "il" planes through ``insert_update_plugin``); each rank keeps its
    rows and re-packs its words.  ``check`` is "warn", "raise" or "defer"
    as in ``DBLIndex.insert_edges``: defer only folds the flag into the
    sticky ``saturated``.  ``rounds`` and ``traffic`` as in
    :func:`distributed_build`."""
    if check not in ("warn", "raise", "defer"):
        raise ValueError(f"unknown check mode {check!r}")
    if idx.scheme != mesh:
        idx = shard_index(idx, mesh)
    il = idx.il_in is not None
    lays = index_shardings(mesh, il=il)
    dev = mesh.device
    ns = torch.from_numpy(np.asarray(new_src, np.int32).ravel()).to(dev)
    nd = torch.from_numpy(np.asarray(new_dst, np.int32).ravel()).to(dev)
    comb = _Combine(mesh, traffic)

    def whole(x, lay):
        """A whole plane of its own: the fixpoints update it in place."""
        if not lay.split_axes():
            return x.clone()
        if traffic is not None:
            traffic.all_gather_calls += 1
            traffic.all_gather_bytes += x.numel() * x.element_size()
        return lay.gather(x).contiguous()

    g2 = _insert_block(idx.graph, mesh, ns, nd)
    view = _edge_view(g2, mesh)
    planes = [whole(getattr(idx, f), getattr(lays, f)) for f in _PLANES]
    planes, iters = U.update_inserted(view, planes, ns, nd, n_cap=idx.n_cap,
                                      max_iters=max_iters, inplace=True,
                                      combine=comb)
    il_kw = {}
    if il:
        p_in, p_out, it_il = U.insert_update_plugin(
            "il", view, whole(idx.il_in, lays.il_in),
            whole(idx.il_out, lays.il_out), ns, nd, n_cap=idx.n_cap,
            max_iters=max_iters, combine=comb)
        il_kw = dict(il_in=_block(p_in, lays.il_in),
                     il_out=_block(p_out, lays.il_out))
        iters = iters + it_il
    _note(rounds, *iters)
    sat = U.saturated(iters, max_iters)
    _surface(sat, check, max_iters)
    rows = [_block(x, lays.dl_in) for x in planes]
    return replace(idx, graph=g2, dl_in=rows[0], dl_out=rows[1],
                   bl_in=rows[2], bl_out=rows[3], packed=Q.pack_labels(*rows),
                   epoch=idx.epoch + 1, saturated=idx.saturated or sat,
                   **il_kw)


def scheme_delete(idx: DBLIndex, del_src, del_dst) -> DBLIndex:
    """``DBLIndex.delete_edges`` on an auto-partitioned index: each rank
    tombstones the matching live slots of its block (no collective)."""
    view = _edge_view(idx.graph, idx.scheme)
    g2, epoch2 = U.delete_and_mark(view, np.asarray(del_src, np.int32),
                                   np.asarray(del_dst, np.int32), idx.epoch)
    return replace(idx, graph=replace(g2, m=idx.graph.m), epoch=epoch2)


def _launch_mesh(mesh) -> Mesh:
    """A vertex mesh as the 1-axis launch mesh its layouts are over."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh((mesh.axis,), (mesh.size,), (mesh.rank,), mesh.device,
                {mesh.axis: mesh.group})


def vertex_index_shardings(mesh, *, il: bool = False) -> DBLIndex:
    """The vertex-sharded layout as a DBLIndex-shaped tree of ``Layout``s
    over a 1-axis mesh (a vertex mesh, or a 1-axis launch mesh): the bool
    and packed planes (and the ``il`` planes) and the (n_cap,) leaf masks
    row-split, everything else (graph, landmarks, epochs) replicated, as
    the reference places them.  A shard of this port keeps its leaf masks
    whole (the delta rebuild reads them whole): their layout's block is
    the rows of them that the shard's planes hold."""
    plane, vec, rep = reach_vertex_shardings(_launch_mesh(mesh))
    g = Graph(src=rep, dst=rep, n=rep, m=rep, del_at=rep, del_epoch=rep)
    packed = Q.PackedLabels(plane, plane, plane, plane)
    return DBLIndex(graph=g, landmarks=rep, dl_in=plane, dl_out=plane,
                    bl_in=plane, bl_out=plane, packed=packed,
                    bl_sources=vec, bl_sinks=vec, epoch=rep,
                    label_del_epoch=rep, saturated=rep,
                    il_in=plane if il else None,
                    il_out=plane if il else None,
                    il_seed=rep if il else None)


def place_vertex_sharded(idx: DBLIndex, mesh: VertexMesh) -> DBLIndex:
    """This rank's shard of a replicated index: its row block of every
    plane, everything else whole, all on ``mesh.device``.
    ``DBLIndex.from_numpy`` followed by this turns label state held as
    numpy arrays (a reference index's, say) into a shard."""
    if idx.layout.sharded:
        raise ValueError("the index is vertex-sharded already")
    layout = PL.vertex_layout(mesh)
    n_loc = PL._check_rows(idx.n_cap, layout)
    rows = slice(layout.rank * n_loc, (layout.rank + 1) * n_loc)
    dev = mesh.device

    def part(t):
        return None if t is None else t[rows].contiguous().to(dev)

    store = PL.PlaneStore(part(idx.dl_in), part(idx.dl_out),
                          part(idx.bl_in), part(idx.bl_out),
                          idx.landmarks.to(dev), idx.bl_sources.to(dev),
                          idx.bl_sinks.to(dev), layout=layout)
    return idx.with_store(store, graph=idx.graph.to(dev),
                          il_in=part(idx.il_in), il_out=part(idx.il_out))


def _halo_options(halo_mode, telemetry, halo_caps) -> dict:
    """The halo options every fixpoint of a lifecycle call takes."""
    check_halo_mode(halo_mode)
    return dict(halo_mode=halo_mode, telemetry=telemetry,
                halo_caps=halo_caps)


def _note(rounds, *iters) -> None:
    if rounds is not None:
        rounds.extend(int(i) for i in iters)


def _il_build_sharded(plan: PL.ShardPlan, n_cap: int, dim: int, seed: int,
                      live: torch.Tensor, max_iters: int, **halo):
    """Sharded twin of ``interval.build_il``: this rank's rows of the rank
    seed plane (drawn whole on the host, a function of (seed, n_cap,
    dim)), both directions through the MIN halo fixpoint from the all-ones
    frontier, with the ``halo`` options (``halo_mode``, ``telemetry``,
    ``halo_caps``).  Returns (il_in, il_out, [iters_in, iters_out])."""
    mesh = plan.mesh
    n_loc = n_cap // mesh.size
    base = rank_plane(n_cap, dim, seed, "cpu")[
        mesh.rank * n_loc:(mesh.rank + 1) * n_loc].to(mesh.device)
    fr = torch.ones(n_loc, dtype=torch.bool, device=mesh.device)
    il_in, it0 = PL.halo_propagate(plan, base, fr, live, monoid="min",
                                   max_iters=max_iters, **halo)
    il_out, it1 = PL.halo_propagate(plan, base, fr, live, reverse=True,
                                    monoid="min", max_iters=max_iters,
                                    **halo)
    return il_in, il_out, [it0, it1]


def build_vertex_sharded(g: Graph, mesh: VertexMesh, *, n_cap: int,
                         k: int = 64, k_prime: int = 64,
                         selection: str = "product", leaf_r: int = 0,
                         max_iters: int = 256, check: str = "warn",
                         plane_repr: str = "bool",
                         families=F.DEFAULT_FAMILIES,
                         il_dim: int = F.DEFAULT_IL_DIM, il_seed: int = 0,
                         halo_mode: str = "dense", hub_count: int = 0,
                         telemetry=None, halo_caps=None, rounds=None
                         ) -> tuple[DBLIndex, PL.ShardPlan]:
    """Alg 1 with vertex-sharded planes: one fused (k + k')-lane halo
    fixpoint per direction over this rank's seed rows, bitwise equal to
    ``DBLIndex.build``.  Returns (this rank's index, plan); the plan
    carries the edge partition and halo routing later inserts and
    rebuilds reuse.  ``families`` adds the "il" rank planes, built through
    the MIN halo fixpoint.  ``rounds``, a list, gets each fixpoint's
    ``iters`` appended (fwd, bwd, then il in, il out).

    ``halo_mode="sparse"`` runs every halo fixpoint through the sparse
    exchange (``core.halo``); ``hub_count`` freezes that many top
    cut-degree vertices on the plan for its hub lane; ``telemetry`` (a
    ``halo.HaloTelemetry``) accumulates the modeled halo bytes and rounds
    of every fixpoint; ``halo_caps`` overrides the sparse capacities."""
    _check_mode(check)
    halo = _halo_options(halo_mode, telemetry, halo_caps)
    plugin_fams = F.plugins(families)
    layout = PL.vertex_layout(mesh)
    PL._check_rows(n_cap, layout)
    g = g.to(mesh.device)
    landmarks = S.select_landmarks(g, n_cap=n_cap, k=k, method=selection)
    sources, sinks = S.leaf_masks(g, n_cap=n_cap, leaf_r=leaf_r)
    seeds = PL.PlaneStore.seeds(landmarks, sources, sinks, n_cap=n_cap,
                                k=k, k_prime=k_prime, layout=layout)
    fr_fwd, fr_bwd = seeds.seed_frontiers()
    plan = PL.shard_plan(g.src, g.dst, g.m, n_cap, mesh,
                         hub_count=hub_count)
    live = G.edge_mask(g)
    x_fwd, it0 = PL.halo_propagate(plan, seeds.fused(), fr_fwd, live,
                                   max_iters=max_iters,
                                   plane_repr=plane_repr, **halo)
    x_bwd, it1 = PL.halo_propagate(plan, seeds.fused(reverse=True), fr_bwd,
                                   live, reverse=True, max_iters=max_iters,
                                   plane_repr=plane_repr, **halo)
    iters = [it0, it1]
    il_kw = {}
    for _ in plugin_fams:
        p_in, p_out, it_f = _il_build_sharded(plan, n_cap, il_dim, il_seed,
                                              live, max_iters, **halo)
        il_kw = dict(il_in=p_in, il_out=p_out, il_seed=int(il_seed))
        iters += it_f
    _note(rounds, *iters)
    sat = U.saturated(iters, max_iters)
    _surface(sat, check, max_iters)
    store = seeds.with_fused(x_fwd, x_bwd)
    idx = DBLIndex(g, landmarks, store.dl_in, store.dl_out, store.bl_in,
                   store.bl_out, store.pack(), sources, sinks, epoch=0,
                   label_del_epoch=g.del_epoch, saturated=sat,
                   layout=layout, **il_kw)
    return idx, plan


def insert_vertex_sharded(idx: DBLIndex, plan: PL.ShardPlan, new_src,
                          new_dst, *, max_iters: int = 256,
                          check: str = "warn", plane_repr: str = "bool",
                          extend: bool = True, halo_mode: str = "dense",
                          telemetry=None, halo_caps=None, rounds=None
                          ) -> tuple[DBLIndex, PL.ShardPlan, bool]:
    """Batched Alg-3 insert on a shard, bitwise equal to
    ``DBLIndex.insert_edges``.  The inserted edges' seed rows cross shards
    once; the fixpoints run on local rows with the halo exchange.
    Returns (index', plan', saturated_now).

    The plan is extended (``planes.extend_plan``, O(m + Δm log Δm) host
    work, no re-sort); ``extend=False`` builds it from scratch, and a plan
    that does not cover exactly the pre-insert edge prefix is rebuilt from
    scratch (keeping its ``hub_count``) with a warning rather than routing
    wrong.  ``rounds`` and the halo options as in
    :func:`build_vertex_sharded`."""
    _check_mode(check)
    halo = _halo_options(halo_mode, telemetry, halo_caps)
    mesh = plan.mesh
    dev = idx.device
    ns_np = np.asarray(new_src, np.int32).ravel()
    nd_np = np.asarray(new_dst, np.int32).ravel()
    ns = torch.from_numpy(ns_np).to(dev)
    nd = torch.from_numpy(nd_np).to(dev)
    m0 = idx.graph.m
    g2 = G.insert_edges(idx.graph, ns, nd)
    if extend and plan.m == m0 and plan.n_cap == idx.n_cap:
        plan2 = PL.extend_plan(plan, ns_np, nd_np)
    else:
        if extend:
            warnings.warn(
                f"stale shard plan (covers m={plan.m}, n_cap={plan.n_cap}; "
                f"graph has m={m0}, n_cap={idx.n_cap}): rebuilding the "
                "routing tables from scratch", stacklevel=2)
        plan2 = PL.shard_plan(g2.src, g2.dst, g2.m, idx.n_cap, mesh,
                              edge_granule=plan.edge_granule,
                              halo_granule=plan.halo_granule,
                              hub_count=plan.hub_count)
    live = G.edge_mask(g2)
    store = idx.store
    seeded_f, fr_f = PL.sharded_seed_scatter(store.fused(), ns, nd,
                                             mesh=mesh)
    x_fwd, it0 = PL.halo_propagate(plan2, seeded_f, fr_f, live,
                                   max_iters=max_iters,
                                   plane_repr=plane_repr, **halo)
    seeded_b, fr_b = PL.sharded_seed_scatter(store.fused(reverse=True),
                                             nd, ns, mesh=mesh)
    x_bwd, it1 = PL.halo_propagate(plan2, seeded_b, fr_b, live,
                                   reverse=True, max_iters=max_iters,
                                   plane_repr=plane_repr, **halo)
    iters = [it0, it1]
    il_kw = {}
    if idx.il_in is not None:
        # the MIN twin of the seeding, with the replicated
        # ``insert_update_il``'s role swap: edge (u, v) hands u's ancestor
        # mins to v and v's reach mins to u
        s_in, fr_i = PL.sharded_seed_scatter_min(idx.il_in, ns, nd,
                                                 mesh=mesh)
        il_in2, it2 = PL.halo_propagate(plan2, s_in, fr_i, live,
                                        monoid="min", max_iters=max_iters,
                                        **halo)
        s_out, fr_o = PL.sharded_seed_scatter_min(idx.il_out, nd, ns,
                                                  mesh=mesh)
        il_out2, it3 = PL.halo_propagate(plan2, s_out, fr_o, live,
                                         reverse=True, monoid="min",
                                         max_iters=max_iters, **halo)
        il_kw = dict(il_in=il_in2, il_out=il_out2)
        iters += [it2, it3]
    _note(rounds, *iters)
    sat_now = U.saturated(iters, max_iters)
    _surface(sat_now, check, max_iters)
    idx2 = idx.with_store(store.with_fused(x_fwd, x_bwd), graph=g2,
                          epoch=idx.epoch + 1,
                          saturated=idx.saturated or sat_now, **il_kw)
    return idx2, plan2, sat_now


def rebuild_vertex_sharded(idx: DBLIndex, plan: PL.ShardPlan | None, *,
                           mesh: VertexMesh | None = None,
                           mode: str = "full", selection: str = "product",
                           leaf_r: int = 0, max_iters: int = 256,
                           compact: bool = True, check: str = "warn",
                           delta_threshold: float = 0.99,
                           plane_repr: str = "bool",
                           halo_mode: str = "dense", telemetry=None,
                           halo_caps=None, rounds=None
                           ) -> tuple[DBLIndex, PL.ShardPlan, dict]:
    """Sharded twin of ``DBLIndex.rebuild_info``: the full Alg-1 rebuild
    or the delta repair on a shard, bitwise equal to the replicated one,
    with the same ``info`` dict.

    The delta plan (invalidation closures, seed churn, estimate) is the
    replicated ``DBLIndex._delta_plan`` on the replicated graph; the
    partial reset is the store's row/column seed reset of this rank's
    rows; the repair fixpoint relaxes the whole live edge set (relaxing
    edges into clean rows changes nothing).  A plan that misses inserts
    catches up by ``extend_plan(dedupe=False)`` over the window; a new
    plan keeps the old one's ``hub_count``.  Returns (index', plan',
    info); ``rounds`` and the halo options as in
    :func:`build_vertex_sharded`."""
    mesh = mesh or (plan.mesh if plan is not None else None)
    if mesh is None:
        raise ValueError("rebuild_vertex_sharded needs a plan or a mesh")
    if mode not in ("full", "delta", "auto"):
        raise ValueError(f"unknown rebuild mode {mode!r}")
    _check_mode(check)
    halo = _halo_options(halo_mode, telemetry, halo_caps)
    n_cap, k, kp = idx.n_cap, idx.k, idx.k_prime
    gran = {} if plan is None else dict(edge_granule=plan.edge_granule,
                                        halo_granule=plan.halo_granule,
                                        hub_count=plan.hub_count)
    build_kw = dict(n_cap=n_cap, k=k, k_prime=kp, selection=selection,
                    leaf_r=leaf_r, max_iters=max_iters, check=check,
                    plane_repr=plane_repr, rounds=rounds,
                    hub_count=gran.get("hub_count", 0), **halo)
    if idx.il_in is not None:
        build_kw.update(families=idx.families, il_dim=idx.il_dim,
                        il_seed=idx.il_seed)

    def full(reason):
        g2 = G.compact(idx.graph) if compact else idx.graph
        idx2, plan2 = build_vertex_sharded(g2, mesh, **build_kw)
        return replace(idx2, epoch=idx.epoch + 1), plan2, \
            {"mode": "full", "reason": reason}

    if mode == "full":
        return full("forced")
    if idx.saturated:
        return full("saturated")
    dplan = idx._delta_plan(selection=selection, leaf_r=leaf_r)
    est = dplan["estimate"]
    if mode == "auto" and est["frac"] > delta_threshold:
        i2, p2, info = full("estimate")
        return i2, p2, {**info, "estimate": est}
    g = idx.graph
    m_now = g.m
    if plan is None or plan.n_cap != n_cap or plan.mesh != mesh \
            or plan.m > m_now:
        plan = PL.shard_plan(g.src, g.dst, m_now, n_cap, mesh, **gran)
    elif plan.m < m_now:
        # O(Δm) catch-up over the slots [plan.m, m_now) inserted since
        # the plan was built; the window may span several batches with
        # deletes between them, so every raw slot is kept (dedupe=False)
        src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
        plan = PL.extend_plan(plan, src[plan.m:m_now], dst[plan.m:m_now],
                              dedupe=False)
    (x_fwd, x_bwd, fresh_fwd, fresh_bwd, seed_fwd, seed_bwd,
     fr_fwd, fr_bwd) = L.delta_plane_state(
        g, idx.dl_in, idx.dl_out, idx.bl_in, idx.bl_out,
        idx.landmarks, dplan["landmarks"], idx.bl_sources, idx.bl_sinks,
        dplan["sources"], dplan["sinks"],
        dplan["dirty_fwd"], dplan["dirty_bwd"],
        n_cap=n_cap, k=k, k_prime=kp, layout=idx.layout)
    live = G.edge_mask(g)
    iters = []
    out = []
    for rev, x, seed, fresh, fr in ((False, x_fwd, seed_fwd, fresh_fwd,
                                     fr_fwd),
                                    (True, x_bwd, seed_bwd, fresh_bwd,
                                     fr_bwd)):
        fr = fr | (seed.bool() & fresh[None, :]).any(1)
        x, it = PL.halo_propagate(plan, x, fr, live, reverse=rev,
                                  max_iters=max_iters, plane_repr=plane_repr,
                                  **halo)
        iters.append(it)
        out.append(x)
    g2 = G.compact(g) if compact else g
    plan2 = PL.shard_plan(g2.src, g2.dst, g2.m, n_cap, mesh, **gran) \
        if compact else plan
    # the "il" repair re-draws both planes from the stored seed over the
    # live edges, as the replicated delta path does
    il_kw = {}
    if idx.il_in is not None:
        p_in, p_out, it_f = _il_build_sharded(
            plan2, n_cap, idx.il_dim, idx.il_seed, G.edge_mask(g2),
            max_iters, **halo)
        il_kw = dict(il_in=p_in, il_out=p_out)
        iters += it_f
    _note(rounds, *iters)
    sat = U.saturated(iters, max_iters)
    _surface(sat, check, max_iters)
    store = idx.store.with_fused(out[0], out[1],
                                 landmarks=dplan["landmarks"],
                                 bl_sources=dplan["sources"],
                                 bl_sinks=dplan["sinks"])
    idx2 = idx.with_store(store, graph=g2, epoch=idx.epoch + 1,
                          label_del_epoch=g2.del_epoch, saturated=sat,
                          **il_kw)
    reason = "forced" if mode == "delta" else "estimate"
    return idx2, plan2, {"mode": "delta", "reason": reason,
                         "estimate": est}
