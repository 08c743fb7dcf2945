"""PlaneStore: label-plane storage with an explicit layout, and the
collectives of the vertex-sharded layout over ``torch.distributed``.

Every DBL lifecycle path (Alg-1 build, Alg-3 insert, delta/full rebuild)
reads and writes the same four uint8 planes (DL-in/out, BL-in/out) and
their seed metadata (the landmark vector and the BL leaf masks).  A
:class:`PlaneStore` holds them with a :class:`PlaneLayout`:

- ``"replicated"``: one process holds every row (the single-device index);
- ``"vertex_sharded"``: SPMD, one process per shard.  Shard ``r`` of ``d``
  holds the contiguous row block ``[r * n_loc, (r + 1) * n_loc)`` of every
  plane (``n_loc = n_cap / d``), so per-device label bytes shrink by ``d``.
  The graph, the landmarks, the leaf masks and the host halves of the
  shard plans are replicated: every rank computes them identically from
  the same inputs, so nothing is broadcast.

The vertex-sharded fixpoints (:func:`halo_propagate`) run on the local
rows.  Edges are bucketed by the owner of their *receiving* endpoint (one
padded bucket per shard, built on the host by :func:`shard_plan`); each
relaxation round exchanges only the boundary frontier rows, the rows of
frontier vertices that sit on a cut edge, through one
``dist.all_to_all_single`` over a precomputed routing table.  Non-frontier
boundary rows travel as the monoid's identity.  Each round ends with one
``dist.all_reduce`` of the frontier count, which every rank reads, so all
ranks take the same branches and issue the same collectives in the same
order; no rank-local data decides a branch.

Labels and round counts are bitwise equal to the replicated fixpoints:
each round is the same edge relaxation with the rows partitioned.

The query side reads rows, never planes: :func:`sharded_rows` and
:func:`sharded_il_rows` rebuild a batch's verdict row blocks on every rank
with one ``all_reduce`` each, and :func:`sharded_pruned_bfs` runs the
residue BFS on the local rows, exchanging boundary frontier bits a round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from . import bitset
from . import query as Q
from .propagate import INT_MAX, check_halo_mode, check_plane_repr
from .select import leaf_hash

#: the name of the axis vertex-sharded planes are partitioned along
VERTEX_AXIS = "vertex"


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error for a reference feature a later slice ports; ``where``
    names its ROADMAP.md queue entry."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, {where})")


# --------------------------------------------------------------- layout
@dataclass(frozen=True)
class PlaneLayout:
    """Where a process's plane rows sit.  ``rank`` is this process's shard
    (0 for the replicated layout): a torch tensor does not know it is a
    shard, so the layout carries it."""
    kind: str = "replicated"          # "replicated" | "vertex_sharded"
    axis: str = VERTEX_AXIS
    shards: int = 1
    rank: int = 0

    def __post_init__(self):
        if self.kind not in ("replicated", "vertex_sharded"):
            raise ValueError(f"unknown plane layout {self.kind!r}")
        if self.kind == "replicated" and self.shards != 1:
            raise ValueError("replicated layout has exactly one shard")
        if not 0 <= self.rank < self.shards:
            raise ValueError(f"rank {self.rank} outside {self.shards} "
                             "shards")

    @property
    def sharded(self) -> bool:
        return self.kind == "vertex_sharded"


REPLICATED = PlaneLayout()


def vertex_layout(mesh) -> PlaneLayout:
    """This process's layout on a vertex mesh (``distributed.vertex_mesh``)."""
    return PlaneLayout("vertex_sharded", VERTEX_AXIS, int(mesh.size),
                       int(mesh.rank))


def layout_of(obj) -> PlaneLayout:
    """The layout of the rows a plane holder holds, as the reference's
    ``layout_of`` reads it off a plane's placement: rows split over more
    than one process is ``"vertex_sharded"`` along the first axis that
    splits them, anything else ``REPLICATED``.  A torch tensor does not
    know it is a shard, so this reads what the port records: an index of
    the auto-partitioned scheme (``scheme``, a launch mesh, whose rows are
    split over every axis, flattened), or the ``layout`` of an index or a
    ``PlaneStore``.  A bare tensor is ``REPLICATED``."""
    scheme = getattr(obj, "scheme", None)
    if scheme is not None:
        if scheme.size > 1:
            rank = int(np.ravel_multi_index(scheme.coords, scheme.shape))
            return PlaneLayout("vertex_sharded", scheme.axis_names[0],
                               scheme.size, rank)
        return REPLICATED
    layout = getattr(obj, "layout", REPLICATED)
    if not isinstance(layout, PlaneLayout) or layout.shards == 1:
        return REPLICATED
    return layout


def _check_rows(n_cap: int, layout: PlaneLayout) -> int:
    if n_cap % layout.shards:
        raise ValueError(f"n_cap={n_cap} must divide evenly into "
                         f"{layout.shards} vertex shards")
    return n_cap // layout.shards


# ----------------------------------------------------------- PlaneStore
class PlaneStore:
    """The four label planes and their seed metadata, with a layout.

    The planes hold this process's rows; ``landmarks`` and the (n_cap,)
    leaf masks are whole on every rank (the delta rebuild's bucket churn
    reads the whole masks).  ``DBLIndex.store`` builds one as a view of
    the index's fields; ``DBLIndex.with_store`` goes back."""

    __slots__ = ("dl_in", "dl_out", "bl_in", "bl_out",
                 "landmarks", "bl_sources", "bl_sinks", "layout")

    def __init__(self, dl_in, dl_out, bl_in, bl_out, landmarks,
                 bl_sources, bl_sinks, layout: PlaneLayout = REPLICATED):
        self.dl_in = dl_in
        self.dl_out = dl_out
        self.bl_in = bl_in
        self.bl_out = bl_out
        self.landmarks = landmarks
        self.bl_sources = bl_sources
        self.bl_sinks = bl_sinks
        self.layout = layout

    # ---- shape helpers --------------------------------------------------
    @property
    def rows(self) -> slice:
        """This process's global row range."""
        n_loc = self.dl_in.shape[0]
        return slice(self.layout.rank * n_loc,
                     (self.layout.rank + 1) * n_loc)

    @property
    def n_cap(self) -> int:
        return self.dl_in.shape[0] * self.layout.shards

    @property
    def k(self) -> int:
        return self.dl_in.shape[1]

    @property
    def k_prime(self) -> int:
        return self.bl_in.shape[1]

    # ---- seed construction (Alg 1 line 1) -------------------------------
    @staticmethod
    def seeds(landmarks, sources, sinks, *, n_cap: int, k: int,
              k_prime: int, layout: PlaneLayout = REPLICATED
              ) -> "PlaneStore":
        """Alg-1 seed planes of this process's rows: landmark lanes
        self-seeded, leaf masks hashed into BL buckets, from global ids.
        Every build and rebuild starts here; the delta rebuild resets
        invalidated entries back to exactly these values."""
        n_loc = _check_rows(n_cap, layout)
        lo = layout.rank * n_loc
        dl = dl_seed_plane(landmarks, n_cap=n_cap, k=k, lo=lo, rows=n_loc)
        return PlaneStore(
            dl, dl,
            bl_seed_plane(sources, n_cap=n_cap, k_prime=k_prime, lo=lo,
                          rows=n_loc),
            bl_seed_plane(sinks, n_cap=n_cap, k_prime=k_prime, lo=lo,
                          rows=n_loc),
            landmarks, sources, sinks, layout=layout)

    def seed_frontiers(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(frontier_fwd, frontier_bwd) of this process's rows: the
        vertices whose seed rows are non-empty per direction (landmarks ∪
        leaf mask)."""
        lm = torch.zeros(self.n_cap, dtype=torch.bool,
                         device=self.bl_sources.device)
        keep = (self.landmarks >= 0) & (self.landmarks < self.n_cap)
        lm[self.landmarks[keep].long()] = True
        rows = self.rows
        return (lm | self.bl_sources)[rows], (lm | self.bl_sinks)[rows]

    # ---- fused planes ---------------------------------------------------
    def fused(self, *, reverse: bool = False) -> torch.Tensor:
        """(rows, k + k') fused plane per direction: DL lanes first, BL
        buckets after.  Lanes are independent under OR, so one fused
        fixpoint per direction computes the bits of the four family
        fixpoints."""
        if reverse:
            return torch.cat([self.dl_out, self.bl_out], 1)
        return torch.cat([self.dl_in, self.bl_in], 1)

    def with_fused(self, x_fwd: torch.Tensor, x_bwd: torch.Tensor,
                   **meta) -> "PlaneStore":
        """Split fused direction planes back into the four family planes."""
        k = self.k
        return PlaneStore(x_fwd[:, :k].contiguous(),
                          x_bwd[:, :k].contiguous(),
                          x_fwd[:, k:].contiguous(),
                          x_bwd[:, k:].contiguous(),
                          meta.get("landmarks", self.landmarks),
                          meta.get("bl_sources", self.bl_sources),
                          meta.get("bl_sinks", self.bl_sinks),
                          layout=self.layout)

    # ---- delta rebuild's partial reset ----------------------------------
    def reset_invalid(self, seeds: "PlaneStore", dirty_fwd, dirty_bwd,
                      fresh_fwd, fresh_bwd
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(x_fwd, x_bwd): fused planes with every invalidated entry reset
        to its Alg-1 seed.  An entry is invalid iff its row is dirty (in
        the deleted edges' invalidation closure for that direction; the
        dirty vectors cover this store's rows) or its column is fresh
        (landmark or leaf-bucket churn).  Row-parallel."""
        def reset(old, seed, dirty, fresh):
            return torch.where(dirty[:, None] | fresh[None, :], seed, old)

        return (reset(self.fused(), seeds.fused(), dirty_fwd, fresh_fwd),
                reset(self.fused(reverse=True), seeds.fused(reverse=True),
                      dirty_bwd, fresh_bwd))

    # ---- packing / accounting -------------------------------------------
    def pack(self) -> Q.PackedLabels:
        return Q.pack_labels(self.dl_in, self.dl_out, self.bl_in,
                             self.bl_out)

    @staticmethod
    def pack_rows(plane: torch.Tensor) -> torch.Tensor:
        """(rows, k) 0/1 plane -> (rows, W) int32 words; row-parallel, so
        a shard packs its own rows with no traffic."""
        return bitset.pack(plane)

    @staticmethod
    def unpack_rows(words: torch.Tensor, k: int,
                    dtype=torch.uint8) -> torch.Tensor:
        """Inverse of :meth:`pack_rows`; row-parallel as well."""
        return bitset.unpack(words, k).to(dtype)

    def label_bytes(self) -> int:
        """Logical (whole-index) bytes of the four uint8 planes."""
        return per_device_label_bytes(self) * self.layout.shards


def dl_seed_plane(landmarks: torch.Tensor, *, n_cap: int, k: int,
                  lo: int = 0, rows: int | None = None) -> torch.Tensor:
    """(rows, k) uint8 DL seeds of global rows ``[lo, lo + rows)`` (all
    ``n_cap`` by default): lane l self-seeded at landmark l.  Landmark ids
    outside ``[0, n_cap)`` are dropped."""
    rows = n_cap if rows is None else rows
    seed = torch.zeros((rows, k), dtype=torch.uint8, device=landmarks.device)
    lanes = torch.arange(k, device=landmarks.device)
    keep = (landmarks >= max(lo, 0)) & (landmarks < min(lo + rows, n_cap))
    seed[landmarks[keep].long() - lo, lanes[keep]] = 1
    return seed


def bl_seed_plane(mask: torch.Tensor, *, n_cap: int, k_prime: int,
                  lo: int = 0, rows: int | None = None) -> torch.Tensor:
    """(rows, k') uint8 BL seeds of global rows ``[lo, lo + rows)`` (all
    ``n_cap`` by default): the (n_cap,) leaf ``mask`` hashed to buckets."""
    rows = n_cap if rows is None else rows
    ids = torch.arange(lo, lo + rows, dtype=torch.int32, device=mask.device)
    h = leaf_hash(ids, k_prime)
    onehot = torch.arange(k_prime, device=mask.device)[None, :] == h[:, None]
    return (onehot & mask[lo:lo + rows, None]).to(torch.uint8)


def per_device_label_bytes(obj) -> int:
    """Bytes of the four uint8 label planes this process holds: the
    quantity the vertex-sharded layout divides by the shard count.
    ``obj`` is a PlaneStore, a DBLIndex or anything with the four plane
    fields."""
    return sum(int(getattr(obj, name).numel())
               * getattr(obj, name).element_size()
               for name in ("dl_in", "dl_out", "bl_in", "bl_out"))


# ----------------------------------------------------------- shard plan
class _DirPlan(NamedTuple):
    """One propagation direction's edge bucket and halo routing, as this
    rank's device rows of the host tables (``host``).

    Edges are bucketed by the owner of their *receiving* endpoint (so the
    reduction is shard-local); the pushing endpoint resolves to a slot in
    the combined table ``[local rows | halo buffer]``.  ``h_send[t]`` lists
    the local rows this rank ships to shard ``t`` each round, in the slot
    order ``t``'s edges expect.  The bucket is sorted by ``e_recv``;
    padding entries carry the sentinel ``e_recv == n_loc``, and
    ``e_start``/``e_tail`` are the segment-boundary flags of that order."""
    e_slot: torch.Tensor    # (E_pad,) int64 — pushing endpoint's table slot
    e_recv: torch.Tensor    # (E_pad,) int64 — receiving endpoint, local row
    e_gid: torch.Tensor     # (E_pad,) int64 — global edge slot (live mask)
    e_valid: torch.Tensor   # (E_pad,) bool  — padding mask
    h_send: torch.Tensor    # (d, H) int64  — local rows to send, per peer
    h_valid: torch.Tensor   # (d, H) bool
    e_start: torch.Tensor   # (E_pad,) bool — first entry of each segment
    e_tail: torch.Tensor    # (E_pad,) bool — last entry of each segment
    host: "_DirHost"        # the whole (d, ...) numpy tables
    # the sparse halo's hub lane (None on a plan without one): the top
    # ``hub_count`` cut vertices by cut degree, frozen when the plan is
    # built, travel once a round on one ``all_reduce`` instead of in up to
    # d - 1 pair buffers
    h_hub: torch.Tensor | None = None     # (d, H) bool: h_send entry is a hub
    hubs: torch.Tensor | None = None      # (Hub,) int64 global ids, pad n_cap
    hub_slot: torch.Tensor | None = None  # (Hub,) int64 slot of each hub in
    #                                       this rank's [local | halo] table;
    #                                       pad n_loc + d*H (dropped)


class ShardPlan(NamedTuple):
    """Host-built routing tables for one (edge set, vertex mesh) pair.

    Rebuilt or extended whenever the edge arrays change shape (inserts
    append; a compacting rebuild renumbers slots); tombstones do not touch
    it, the live mask is gathered per round through ``e_gid``.  Extents
    are rounded up to granules; the granules are recorded so
    :func:`extend_plan` rounds on the same grid."""
    mesh: object          # distributed.VertexMesh
    n_cap: int
    m: int                # edge prefix the plan covers
    fwd: _DirPlan
    bwd: _DirPlan
    edge_granule: int = 1024
    halo_granule: int = 64
    hub_count: int = 0    # the hub lane's width (0: no hub lane)

    @property
    def shards(self) -> int:
        return int(self.mesh.size)

    @property
    def axis(self) -> str:
        return self.mesh.axis


def _round_up(x: int, granule: int) -> int:
    return max(granule, -(-x // granule) * granule)


class _DirHost(NamedTuple):
    """The numpy tables of one direction, bit-identical to the reference's
    (``(d, E_pad)`` buckets, ``(d, d, H)`` halo lists, and with a hub lane
    the ``(d, d, H)`` hub flags, the ``(d, Hub)`` receiver slots and the
    real hub ids, sorted)."""
    e_slot: np.ndarray
    e_recv: np.ndarray
    e_gid: np.ndarray
    e_valid: np.ndarray
    h_send: np.ndarray
    h_valid: np.ndarray
    h_hub: np.ndarray | None = None
    hub_slot: np.ndarray | None = None
    hubs: np.ndarray | None = None


def _select_hubs(need: list, hub_count: int) -> np.ndarray:
    """The top ``hub_count`` cut vertices by cut degree (the number of
    (receiver, sender) need lists holding the vertex), degree-1 vertices
    left out: a broadcast pays only for a row that several pair buffers
    would carry.  Ties break on the vertex id; sorted ascending."""
    d = len(need)
    lists = [need[t][s] for t in range(d) for s in range(d)
             if need[t][s].size]
    if hub_count <= 0 or not lists:
        return np.zeros(0, np.int64)
    verts, cnts = np.unique(np.concatenate(lists), return_counts=True)
    keep = cnts >= 2
    verts, cnts = verts[keep], cnts[keep]
    order = np.lexsort((verts, -cnts))
    return np.sort(verts[order[:hub_count]])


def _hub_positions(hubs_np: np.ndarray, ids: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(index into ``hubs_np``, is-a-hub mask) of each of ``ids``."""
    j = np.searchsorted(hubs_np, ids)
    jc = np.minimum(j, hubs_np.size - 1)
    return j, (j < hubs_np.size) & (hubs_np[jc] == ids)


def _segment_flags(e_recv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(e_start, e_tail) of recv-sorted ``(d, E_pad)`` buckets."""
    start = np.zeros(e_recv.shape, bool)
    tail = np.zeros(e_recv.shape, bool)
    start[:, 0] = True
    start[:, 1:] = e_recv[:, 1:] != e_recv[:, :-1]
    tail[:, :-1] = e_recv[:, 1:] != e_recv[:, :-1]
    tail[:, -1] = True
    return start, tail


def _build_dir(push: np.ndarray, recv: np.ndarray, m: int, n_loc: int,
               d: int, edge_granule: int, halo_granule: int,
               hub_count: int = 0) -> _DirHost:
    """One direction's tables over the edge prefix ``[0, m)``, with the
    hub lane's tables when ``hub_count > 0``."""
    gids = np.arange(m, dtype=np.int64)
    owner_recv = recv[:m].astype(np.int64) // n_loc
    owner_push = push[:m].astype(np.int64) // n_loc
    # each bucket sorted by local receiving row, as the packed segment-OR
    # needs; the bool and MIN reductions do not depend on the order
    per_shard = []
    for t in range(d):
        e = gids[owner_recv == t]
        per_shard.append(e[np.argsort(recv[e], kind="stable")])
    # need[t][s]: sorted unique push vertices owned by s that t's bucket
    # references (s != t)
    need = [[np.zeros(0, np.int64)] * d for _ in range(d)]
    for t in range(d):
        e = per_shard[t]
        for s in range(d):
            if s == t:
                continue
            sel = e[owner_push[e] == s]
            need[t][s] = np.unique(push[sel])
    H = _round_up(max([1] + [need[t][s].size for t in range(d)
                             for s in range(d)]), halo_granule)
    E_pad = _round_up(max([1] + [e.size for e in per_shard]), edge_granule)

    e_slot = np.zeros((d, E_pad), np.int32)
    # padding entries carry the out-of-range recv sentinel n_loc, which
    # every reduction drops, and which keeps each row non-decreasing
    e_recv = np.full((d, E_pad), n_loc, np.int32)
    e_gid = np.zeros((d, E_pad), np.int32)
    e_valid = np.zeros((d, E_pad), bool)
    h_send = np.zeros((d, d, H), np.int32)
    h_valid = np.zeros((d, d, H), bool)
    for t in range(d):
        e = per_shard[t]
        ne = e.size
        e_gid[t, :ne] = e
        e_valid[t, :ne] = True
        e_recv[t, :ne] = recv[e] - t * n_loc
        pu = push[e]
        own = owner_push[e]
        slot = np.where(own == t, pu - t * n_loc, 0).astype(np.int64)
        for s in range(d):
            if s == t or need[t][s].size == 0:
                continue
            sel = own == s
            pos = np.searchsorted(need[t][s], pu[sel])
            slot[sel] = n_loc + s * H + pos
        e_slot[t, :ne] = slot
    for s in range(d):
        for t in range(d):
            ids = need[t][s]
            h_send[s, t, :ids.size] = ids - s * n_loc
            h_valid[s, t, :ids.size] = True
    if hub_count <= 0:
        return _DirHost(e_slot, e_recv, e_gid, e_valid, h_send, h_valid)
    # the hub lane, frozen here: hub j's slot in receiver t's combined
    # table; the pad slot n_loc + d*H is one past the table, so dropped
    hubs_np = _select_hubs(need, hub_count)
    h_hub = np.zeros((d, d, H), bool)
    hub_slot = np.full((d, hub_count), n_loc + d * H, np.int64)
    if hubs_np.size:
        for t in range(d):
            for s in range(d):
                ids = need[t][s]
                if ids.size == 0:
                    continue
                j, ishub = _hub_positions(hubs_np, ids)
                h_hub[s, t, :ids.size] = ishub
                pos = np.arange(ids.size)
                hub_slot[t, j[ishub]] = n_loc + s * H + pos[ishub]
    return _DirHost(e_slot, e_recv, e_gid, e_valid, h_send, h_valid,
                    h_hub, hub_slot, hubs_np)


def _upload_dir(host: _DirHost, rank: int, device, n_cap: int,
                old: _DirPlan | None = None) -> _DirPlan:
    """This rank's device rows of ``host``; with a hub lane also the hub
    ids, padded to ``Hub`` with ``n_cap`` (owned by no shard).  Halo tables
    that are the very arrays of ``old.host`` keep ``old``'s device tensors
    (the hub tables change only with them; the hub ids never do)."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[rank])).to(
            device=device, dtype=dtype)

    start, tail = _segment_flags(host.e_recv)
    hub = {}
    if old is not None and host.h_send is old.host.h_send \
            and host.h_valid is old.host.h_valid:
        h_send, h_valid = old.h_send, old.h_valid
        hub = dict(h_hub=old.h_hub, hub_slot=old.hub_slot)
    else:
        h_send, h_valid = up(host.h_send, torch.int64), \
            up(host.h_valid, torch.bool)
        if host.h_hub is not None:
            hub = dict(h_hub=up(host.h_hub, torch.bool),
                       hub_slot=up(host.hub_slot, torch.int64))
    if host.h_hub is not None:
        if old is not None:
            hub["hubs"] = old.hubs
        else:
            ids = np.full(host.hub_slot.shape[1], n_cap, np.int64)
            ids[:host.hubs.size] = host.hubs
            hub["hubs"] = torch.from_numpy(ids).to(device)
    return _DirPlan(up(host.e_slot, torch.int64), up(host.e_recv, torch.int64),
                    up(host.e_gid, torch.int64), up(host.e_valid, torch.bool),
                    h_send, h_valid, up(start, torch.bool),
                    up(tail, torch.bool), host, **hub)


def _host_edges(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def shard_plan(src, dst, m: int, n_cap: int, mesh, *,
               edge_granule: int = 1024, halo_granule: int = 64,
               hub_count: int = 0) -> ShardPlan:
    """Partition the edge prefix ``[0, m)`` for a vertex mesh, on the host.

    ``src``/``dst`` are the graph's (m_cap,) edge arrays (numpy or torch;
    read once).  O(m log m) numpy work, paid at build time and after a
    compacting rebuild, never per query.  Every rank builds the same
    tables and uploads its own rows to ``mesh.device``.  ``hub_count > 0``
    also picks each direction's top ``hub_count`` cut vertices for the
    sparse halo's hub lane, frozen until the next plan from scratch."""
    layout = vertex_layout(mesh)
    n_loc = _check_rows(n_cap, layout)
    src, dst = _host_edges(src), _host_edges(dst)
    d, m = layout.shards, int(m)
    fwd = _build_dir(src, dst, m, n_loc, d, edge_granule, halo_granule,
                     hub_count)
    bwd = _build_dir(dst, src, m, n_loc, d, edge_granule, halo_granule,
                     hub_count)
    return ShardPlan(mesh, n_cap, m,
                     _upload_dir(fwd, layout.rank, mesh.device, n_cap),
                     _upload_dir(bwd, layout.rank, mesh.device, n_cap),
                     edge_granule=edge_granule, halo_granule=halo_granule,
                     hub_count=hub_count)


# ------------------------------------------- incremental plan extension
def _normalize_batch(new_src, new_dst, m0: int, dedupe: bool = True
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Normalize one insert batch for plan extension.  With ``dedupe``
    self-loops and in-batch duplicate pairs are dropped, keeping each
    pair's first (lowest-gid) slot: self-loops are no-ops in every
    fixpoint, and duplicate slots of one batch are created live together
    and die together.  ``dedupe=False`` keeps every raw slot, as a
    from-scratch ``_build_dir`` does; it is the only sound mode for a
    window spanning several batches (the rebuild's catch-up), where a pair
    inserted, deleted and re-inserted has a dead slot below its live twin.

    Returns (src, dst, gid, raw): the kept edges, their global slots
    (``m0 + position in the raw batch``) and the raw batch size."""
    src = np.asarray(new_src, np.int64).ravel()
    dst = np.asarray(new_dst, np.int64).ravel()
    raw = int(src.size)
    gid = m0 + np.arange(raw, dtype=np.int64)
    if raw == 0 or not dedupe:
        return src, dst, gid, raw
    hi = int(max(src.max(), dst.max())) + 1
    _, first = np.unique(src * hi + dst, return_index=True)
    keep = np.zeros(raw, bool)
    keep[first] = True
    keep &= src != dst
    return src[keep], dst[keep], gid[keep], raw


def _extend_dir(host: _DirHost, push: np.ndarray, recv: np.ndarray,
                gid: np.ndarray, n_loc: int, d: int, edge_granule: int,
                halo_granule: int) -> _DirHost:
    """Merge a normalized Δ-batch into one direction's tables.

    Buckets stay sorted by local receiving row with one ``e_tail`` per
    segment: new edges merge into recv-sorted position by two searchsorted
    passes (new gids after old ones within equal recv), reproducing the
    from-scratch order of ``e_recv``/``e_gid``.  ``h_send`` appends fresh
    cut vertices after the existing slots, so its order (and the
    ``e_slot`` values into it) may differ from a from-scratch build while
    the decoded slot -> pushing-vertex map is the same.  A batch with no
    cut edge returns the very ``h_send``/``h_valid`` arrays.  Where a
    bucket's batch lands at or after its last occupied recv row, the merge
    is skipped (the append-sorted fast path).  The hub set stays frozen:
    a hub entering a send list gets its flag and receiver slot, and a
    grown halo remaps the hub slots into the new stride."""
    e_slot, e_recv, e_gid = host.e_slot, host.e_recv, host.e_gid
    h_send, h_valid = host.h_send, host.h_valid
    E_old = e_recv.shape[1]
    H_old = h_send.shape[2]
    ne = host.e_valid.sum(axis=1)                  # (d,) valid prefix sizes
    hc = h_valid.sum(axis=2)                       # (d, d) halo list sizes
    owner_recv = recv // n_loc
    owner_push = push // n_loc
    cut = owner_push != owner_recv

    # ---- halo send lists: append fresh cut vertices per (sender,
    # receiver) pair; existing vertices keep their positions
    slot_pos: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    new_halo: dict[tuple[int, int], np.ndarray] = {}
    H_needed = H_old
    if cut.any():
        pairs = {(int(s), int(t))
                 for s, t in zip(owner_push[cut], owner_recv[cut])}
        for s, t in sorted(pairs):
            sel = cut & (owner_push == s) & (owner_recv == t)
            verts = np.unique(push[sel])
            c = int(hc[s, t])
            need = h_send[s, t, :c].astype(np.int64) + s * n_loc
            order = np.argsort(need, kind="stable")
            sorted_need = need[order]
            pos = np.empty(verts.size, np.int64)
            if c:
                j = np.searchsorted(sorted_need, verts)
                jc = np.minimum(j, c - 1)
                found = (j < c) & (sorted_need[jc] == verts)
                pos[found] = order[jc[found]]
            else:
                found = np.zeros(verts.size, bool)
            fresh = verts[~found]
            pos[~found] = c + np.arange(fresh.size)
            slot_pos[(s, t)] = (verts, pos)
            new_halo[(s, t)] = fresh
            H_needed = max(H_needed, c + fresh.size)
    grew_h = H_needed > H_old
    H_new = _round_up(H_needed, halo_granule) if grew_h else H_old
    h_hub, hub_slot, hubs_np = host.h_hub, host.hub_slot, host.hubs
    hh2, hub_slot2 = h_hub, hub_slot
    if grew_h:
        hs2 = np.zeros((d, d, H_new), np.int32)
        hv2 = np.zeros((d, d, H_new), bool)
        hs2[:, :, :H_old] = h_send
        hv2[:, :, :H_old] = h_valid
        if h_hub is not None:
            hh2 = np.zeros((d, d, H_new), bool)
            hh2[:, :, :H_old] = h_hub
            # the stride n_loc + s*H + pos changed: remap the hub slots and
            # move the drop sentinel to the new table's end, as e_slot below
            off = hub_slot - n_loc
            hub_slot2 = np.where(
                hub_slot >= n_loc + d * H_old, n_loc + d * H_new,
                np.where(hub_slot >= n_loc,
                         n_loc + (off // H_old) * H_new + off % H_old,
                         hub_slot))
    elif new_halo:
        hs2 = h_send.copy()
        hv2 = h_valid.copy()
        if h_hub is not None:
            hh2, hub_slot2 = h_hub.copy(), hub_slot.copy()
    else:
        hs2, hv2 = h_send, h_valid     # zero-cut batch: the very arrays
    for (s, t), fresh in new_halo.items():
        c = int(hc[s, t])
        hs2[s, t, c:c + fresh.size] = (fresh - s * n_loc).astype(np.int32)
        hv2[s, t, c:c + fresh.size] = True
        # fresh cut vertices of the frozen hub set get their hub flags and
        # receiver slots as they enter the send lists
        if hubs_np is not None and hubs_np.size and fresh.size:
            j, ishub = _hub_positions(hubs_np, fresh)
            pos = c + np.arange(fresh.size)
            hh2[s, t, pos[ishub]] = True
            hub_slot2[t, j[ishub]] = n_loc + s * H_new + pos[ishub]

    # ---- edge buckets: merge per receiving shard -----------------------
    counts = np.bincount(owner_recv, minlength=d)[:d]
    E_needed = int((ne + counts).max())
    E_new = _round_up(E_needed, edge_granule) if E_needed > E_old else E_old
    if grew_h:
        # the combined-table stride n_loc + s*H + pos changed: remap every
        # existing halo slot into the new stride
        off = e_slot - n_loc
        e_slot = np.where(e_slot >= n_loc,
                          n_loc + (off // H_old) * H_new + off % H_old,
                          e_slot)
    s2 = np.zeros((d, E_new), np.int32)
    r2 = np.full((d, E_new), n_loc, np.int32)
    g2 = np.zeros((d, E_new), np.int32)
    v2 = np.zeros((d, E_new), bool)
    for t in range(d):
        nold = int(ne[t])
        sel = owner_recv == t
        b = int(sel.sum())
        if b == 0:
            s2[t, :nold] = e_slot[t, :nold]
            r2[t, :nold] = e_recv[t, :nold]
            g2[t, :nold] = e_gid[t, :nold]
            v2[t, :nold] = True
            continue
        rl = recv[sel] - t * n_loc
        order = np.argsort(rl, kind="stable")
        rl_s = rl[order]
        gid_s = gid[sel][order]
        push_s = push[sel][order]
        own_s = owner_push[sel][order]
        slot_new = np.where(own_s == t, push_s - t * n_loc, 0)
        for s in np.unique(own_s[own_s != t]):
            verts, pos = slot_pos[(int(s), t)]
            msel = own_s == s
            k = np.searchsorted(verts, push_s[msel])
            slot_new[msel] = n_loc + int(s) * H_new + pos[k]
        if nold == 0 or rl_s[0] >= int(e_recv[t, nold - 1]):
            # append-sorted fast path: the tail positions are the ones the
            # two-pass merge would pick
            s2[t, :nold] = e_slot[t, :nold]
            s2[t, nold:nold + b] = slot_new
            r2[t, :nold] = e_recv[t, :nold]
            r2[t, nold:nold + b] = rl_s
            g2[t, :nold] = e_gid[t, :nold]
            g2[t, nold:nold + b] = gid_s
            v2[t, :nold + b] = True
            continue
        old_r = e_recv[t, :nold].astype(np.int64)
        dst_old = np.arange(nold) + np.searchsorted(rl_s, old_r, "left")
        dst_new = np.searchsorted(old_r, rl_s, "right") + np.arange(b)
        s2[t, dst_old] = e_slot[t, :nold].astype(np.int32)
        s2[t, dst_new] = slot_new.astype(np.int32)
        r2[t, dst_old] = e_recv[t, :nold]
        r2[t, dst_new] = rl_s.astype(np.int32)
        g2[t, dst_old] = e_gid[t, :nold]
        g2[t, dst_new] = gid_s.astype(np.int32)
        v2[t, :nold + b] = True
    return _DirHost(s2, r2, g2, v2, hs2, hv2, hh2, hub_slot2, hubs_np)


def extend_plan(plan: ShardPlan, new_src, new_dst, *,
                edge_granule: int | None = None,
                halo_granule: int | None = None,
                dedupe: bool = True) -> ShardPlan:
    """Append a Δ-batch into a plan's tables: the O(m + Δm log Δm)
    incremental twin of :func:`shard_plan` (no re-sort of the existing
    edges).  The new edges take global slots ``[plan.m, plan.m + Δ)``, as
    ``graph.insert_edges`` assigns them.  ``e_recv``/``e_gid``/``e_valid``
    (and the segment flags) equal a from-scratch plan's bit for bit;
    ``h_send``/``e_slot`` decode to the same push map (see
    :func:`_extend_dir`).  ``dedupe`` must be False for a window spanning
    several insert batches (see :func:`_normalize_batch`).

    Extents are kept while the new entries fit the granule-rounded tails
    and spill to ``_round_up(needed, granule)``, the from-scratch extent,
    otherwise; granules default to the plan's.  A batch that normalizes to
    nothing returns the plan with only ``m`` advanced."""
    edge_granule = plan.edge_granule if edge_granule is None else edge_granule
    halo_granule = plan.halo_granule if halo_granule is None else halo_granule
    layout = vertex_layout(plan.mesh)
    n_loc = _check_rows(plan.n_cap, layout)
    d = layout.shards
    src, dst, gid, raw = _normalize_batch(new_src, new_dst, plan.m, dedupe)
    m2 = plan.m + raw
    if src.size == 0:
        return plan._replace(m=m2)
    fwd = _extend_dir(plan.fwd.host, src, dst, gid, n_loc, d,
                      edge_granule, halo_granule)
    bwd = _extend_dir(plan.bwd.host, dst, src, gid, n_loc, d,
                      edge_granule, halo_granule)
    dev, n_cap = plan.mesh.device, plan.n_cap
    return ShardPlan(plan.mesh, n_cap, m2,
                     _upload_dir(fwd, layout.rank, dev, n_cap, plan.fwd),
                     _upload_dir(bwd, layout.rank, dev, n_cap, plan.bwd),
                     edge_granule=edge_granule, halo_granule=halo_granule,
                     hub_count=plan.hub_count)


# ------------------------------------------------- sharded collectives
def _exchange(mesh, send: torch.Tensor) -> torch.Tensor:
    """All-to-all of a (d, H, ...) tensor: chunk ``t`` goes to rank ``t``,
    and chunk ``s`` of the result is what rank ``s`` sent here."""
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send.contiguous(), group=mesh.group)
    return out


def _global_count(mesh, flags: torch.Tensor) -> int:
    """The frontier size over every shard: one ``all_reduce`` and one
    host read, the same value on every rank."""
    t = flags.sum(dtype=torch.int64).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return int(t.item())


def _dense_exchange(mesh, dp: _DirPlan, x, fr, fill):
    """The dense round's exchange: every pair's whole H-slot buffer, the
    frontier rows and ``fill`` (the monoid's identity) elsewhere.  Returns
    the combined table ``[local rows | halo]`` and its frontier."""
    d, H = dp.h_send.shape
    sf = dp.h_valid & fr[dp.h_send]                        # (d, H)
    sr = torch.where(sf[..., None], x[dp.h_send],
                     torch.full((), fill, dtype=x.dtype, device=x.device))
    rf = _exchange(mesh, sf.to(torch.uint8))
    rr = _exchange(mesh, sr)
    comb = torch.cat([x, rr.reshape(d * H, x.shape[1])])
    frc = torch.cat([fr, rf.reshape(d * H).bool()])
    return comb, frc


def _relaxer(dp: _DirPlan, live, monoid: str, packed: bool, k: int):
    """``relax(x, comb, frc) -> (x', changed rows)``: one round's edge
    relaxation of the local rows from a combined table and its frontier,
    over the active bucket entries (frontier pusher, live, not padding).
    OR is ``"amax"`` on 0/1 uint8 rows and MIN ``"amin"`` on int32 ranks,
    both over the active entries only, which drops the padding sentinel;
    words OR through ``bitset.segment_or_flags`` over the whole bucket
    with the plan's segment flags."""
    edge_ok = live[dp.e_gid] & dp.e_valid
    if packed:
        mask = bitset.pad_mask(k, dp.e_recv.device)
        zero = torch.zeros((), dtype=torch.int32, device=dp.e_recv.device)

        def relax(xw, comb, frc):
            active = frc[dp.e_slot] & edge_ok
            vals = torch.where(active[:, None], comb[dp.e_slot], zero)
            agg = bitset.segment_or_flags(vals, dp.e_start, dp.e_tail,
                                          dp.e_recv, xw.shape[0])
            new = (xw | agg) & mask
            return new, (new != xw).any(-1)
        return relax
    reduce = "amin" if monoid == "min" else "amax"

    def relax(x, comb, frc):
        eidx = torch.nonzero(frc[dp.e_slot] & edge_ok).squeeze(1)
        new = x.clone()
        new.index_reduce_(0, dp.e_recv[eidx], comb[dp.e_slot[eidx]],
                          reduce, include_self=True)
        return new, (new != x).any(-1)
    return relax


def _fixpoint(mesh, step, x, frontier, max_iters: int):
    """Run ``step`` while the global frontier is non-empty and ``it <
    max_iters``; ``iters = max_iters + 1`` when it was cut off live."""
    fr = frontier.to(torch.bool)
    it = 0
    alive = _global_count(mesh, fr) > 0
    while alive and it < max_iters:
        x, fr = step(x, fr)
        it += 1
        alive = _global_count(mesh, fr) > 0
    return x, (max_iters + 1 if alive else it)


def halo_row_bytes(k: int, monoid: str, packed: bool) -> int:
    """Bytes of one halo row as it crosses: uint8 lanes, int32 words (32
    lanes a word) or int32 ranks."""
    if packed:
        return 4 * bitset.n_words(k)
    return 4 * k if monoid == "min" else k


def halo_propagate(plan: ShardPlan, x: torch.Tensor, frontier: torch.Tensor,
                   live: torch.Tensor, *, reverse: bool = False,
                   max_iters: int = 256, monoid: str = "or",
                   plane_repr: str = "bool", halo_mode: str = "dense",
                   telemetry=None, halo_caps=None
                   ) -> tuple[torch.Tensor, int]:
    """Vertex-sharded twin of ``propagate.propagate``: ``x`` and
    ``frontier`` are this rank's rows, ``live`` the whole (m_cap,) live
    mask.  Returns (rows, iters), ``iters = max_iters + 1`` when the loop
    was cut off with the global frontier non-empty; both bitwise equal to
    the replicated fixpoint.

    ``plane_repr="packed"`` runs the OR fixpoint on int32 words (rows pack
    and unpack locally; halo rows travel as words).  ``monoid="min"``
    relaxes int32 rank planes (the "il" family) and has no packed form.
    A dense round costs two ``all_to_all_single`` (frontier flags as
    uint8, rows) and one ``all_reduce`` of the frontier count.

    ``halo_mode="sparse"`` moves only the changed boundary rows
    (``core.halo.sparse_halo_propagate``: compacted pair buckets, a dense
    fallback on overflow, the plan's hub lane, local rounds with no
    payload), bitwise equal to the dense exchange.  ``telemetry`` (a
    ``halo.HaloTelemetry``) accumulates the modeled halo bytes and rounds
    of either mode; ``halo_caps`` overrides the sparse bucket capacities
    (``halo.bucket_caps``)."""
    check_plane_repr(plane_repr)
    check_halo_mode(halo_mode)
    if monoid not in ("or", "min"):
        raise ValueError(f"unknown monoid {monoid!r}")
    if monoid == "min" and plane_repr == "packed":
        raise ValueError("plane_repr='packed' supports the OR monoid only")
    if halo_mode == "sparse":
        from . import halo
        return halo.sparse_halo_propagate(
            plan, x, frontier, live, reverse=reverse, max_iters=max_iters,
            monoid=monoid, plane_repr=plane_repr, telemetry=telemetry,
            caps=halo_caps)
    dp = plan.bwd if reverse else plan.fwd
    mesh = plan.mesh
    k = x.shape[1]
    packed = plane_repr == "packed"
    relax = _relaxer(dp, live, monoid, packed, k)
    fill = INT_MAX if monoid == "min" else 0

    def step(x, fr):
        return relax(x, *_dense_exchange(mesh, dp, x, fr, fill))

    work = PlaneStore.pack_rows(x) if packed else x
    out, iters = _fixpoint(mesh, step, work, frontier, max_iters)
    if telemetry is not None:
        # every ordered pair ships its whole H-slot buffer (rows and
        # one-byte flags) every round
        d, H = dp.h_send.shape
        telemetry.add_dense(iters, d * (d - 1) * H
                            * (halo_row_bytes(k, monoid, packed) + 1),
                            max_iters)
    return (PlaneStore.unpack_rows(out, k, x.dtype) if packed else out), \
        iters


def _owned_rows(x: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    """Rows of global ``ids`` in the local block ``x`` (global rows ``[lo,
    lo + len(x))``), zero where this shard does not own the id."""
    n_loc = x.shape[0]
    ids = ids.long()
    local = (ids >= lo) & (ids < lo + n_loc)
    return torch.where(local[:, None], x[(ids - lo).clamp(0, n_loc - 1)],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _reconstruct(mesh, blocks) -> list[torch.Tensor]:
    """The owners' rows of every block on every rank: one
    ``all_reduce(SUM)`` over the blocks concatenated along the columns.
    Exact for any int32 (words with the top bit set, negative ranks):
    each in-range row has one owner and every other shard adds zeros."""
    cat = torch.cat(blocks, 1)
    dist.all_reduce(cat, op=dist.ReduceOp.SUM, group=mesh.group)
    return list(torch.split(cat, [b.shape[1] for b in blocks], 1))


def _seed_rows(x, at_src, at_dst, mesh):
    """(the ``at_src`` rows of the entries whose ``at_dst`` row is owned
    here, gathered from their owners by :func:`_reconstruct`, and those
    local destination rows)."""
    n_loc = x.shape[0]
    lo = mesh.rank * n_loc
    ns = torch.as_tensor(at_src, device=x.device).long()
    nd = torch.as_tensor(at_dst, device=x.device).long()
    rows, = _reconstruct(mesh, [_owned_rows(x, ns, lo)])
    owned = torch.nonzero((nd >= lo) & (nd < lo + n_loc)).squeeze(1)
    return rows[owned], nd[owned] - lo


def _seed_scatter(x, at_src, at_dst, mesh, reduce):
    new = x.clone()
    if int(torch.as_tensor(at_src).numel()):
        rows, ldst = _seed_rows(x, at_src, at_dst, mesh)
        new.index_reduce_(0, ldst, rows, reduce, include_self=True)
    return new, (new != x).any(-1)


def sharded_seed_scatter(x: torch.Tensor, at_src, at_dst, *, mesh
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded Alg-3 seeding: OR row ``x[at_src[i]]`` into row
    ``x[at_dst[i]]`` (global ids) on this rank's rows.  The b source rows
    cross shards once (O(b·k)); the scatter lands only on rows owned
    here.  Returns (seeded rows, changed-row frontier)."""
    return _seed_scatter(x, at_src, at_dst, mesh, "amax")


def sharded_seed_scatter_min(x: torch.Tensor, at_src, at_dst, *, mesh
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """MIN twin of :func:`sharded_seed_scatter` for int32 rank planes:
    ``min(x[at_dst[i]], x[at_src[i]])`` row-wise."""
    return _seed_scatter(x, at_src, at_dst, mesh, "amin")


# ------------------------------------------------ sharded query side
def sharded_rows(p: Q.PackedLabels, u: torch.Tensor, v: torch.Tensor, *,
                 mesh) -> Q.RowBlocks:
    """The eight (Q, W) row blocks of ``query.gather_rows`` from
    row-sharded word planes, on every rank: each shard gathers the (u, v)
    rows it owns (zeros elsewhere) and one ``all_reduce(SUM)`` rebuilds
    the blocks, O(Q·W) traffic and no all-gather.  Ids outside ``[0,
    n_cap)`` (the engine's dead-lane sentinel ``n_cap``) have no owner
    and come back as all-zero rows."""
    lo = mesh.rank * p.dl_in.shape[0]
    return Q.RowBlocks(*_reconstruct(mesh, [
        _owned_rows(plane, ids, lo)
        for plane, ids in ((p.dl_out, u), (p.dl_in, v), (p.dl_out, v),
                           (p.dl_in, u), (p.bl_in, u), (p.bl_in, v),
                           (p.bl_out, v), (p.bl_out, u))]))


def sharded_il_rows(il, u: torch.Tensor, v: torch.Tensor, *, mesh):
    """The four (Q, 2*dim) int32 interval rows of
    ``query.gather_il_rows``, ``(il_out[u], il_out[v], il_in[u],
    il_in[v])``, from row-sharded rank planes: the int32 twin of
    :func:`sharded_rows`, one ``all_reduce(SUM)`` (exact for any-sign
    ranks).  Unowned ids come back as zero rows; ``0 > 0`` never holds,
    so such lanes never prune."""
    il_in, il_out = il
    lo = mesh.rank * il_in.shape[0]
    return tuple(_reconstruct(mesh, [
        _owned_rows(plane, ids, lo)
        for plane, ids in ((il_out, u), (il_out, v), (il_in, u),
                           (il_in, v))]))


def _lane_state(mesh, frontier: torch.Tensor, hit_loc: torch.Tensor
                ) -> torch.Tensor:
    """(1 + Qc,) int64 on every rank: the global frontier count, then
    the per-lane hit counts; one ``all_reduce``."""
    t = torch.cat([frontier.sum(dtype=torch.int64).reshape(1),
                   hit_loc.to(torch.int64)])
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def sharded_pruned_bfs(plan: ShardPlan, p: Q.PackedLabels,
                       rows: Q.RowBlocks, u: torch.Tensor, v: torch.Tensor,
                       live: torch.Tensor, m_cut: torch.Tensor, m_total,
                       dl_clean, *, max_iters: int = 256,
                       frontier_dtype: str = "int8") -> torch.Tensor:
    """(Qc,) bool on every rank: the vertex-sharded twin of
    ``query.pruned_bfs`` over the plan's ``fwd`` direction, bitwise equal
    to it.

    The admit, frontier and visited planes hold this rank's rows.  The
    admit block comes from the local plane rows and the reconstructed
    query rows (``rows``, from :func:`sharded_rows`), with the DL term
    gated by ``(m_cut >= m_total) & dl_clean``.  Each round exchanges the
    boundary frontier bits, (d, H, Qc) uint8, through the plan's halo
    lists (one ``all_to_all_single``), relaxes the round's active bucket
    entries under the per-lane edge-count cutoff, and gates by admit,
    visited and hit.  One ``all_reduce`` a round carries the global
    frontier count and the per-lane hits, found on the rank that owns
    ``v``; one host read a round decides the loop, as the reference's
    ``cond`` does (frontier alive, some lane not hit, ``it <
    max_iters``).  Dead lanes carry ``u = n_cap``: no rank owns it, so
    their frontier starts empty.  The interval prune is not applied: it
    is sound, so the hits are the same without it."""
    if frontier_dtype not in ("int8", "int32"):
        raise ValueError("the sharded residue BFS keeps per-lane frontier "
                         f"planes: frontier_dtype 'int8' or 'int32', not "
                         f"{frontier_dtype!r}")
    ftype = Q.FRONTIER_DTYPES[frontier_dtype]
    mesh, dp = plan.mesh, plan.fwd
    n_loc = p.dl_in.shape[0]
    lo = mesh.rank * n_loc
    dev = p.dl_in.device
    qc = u.shape[0]
    d, H = dp.h_send.shape
    dl_on = (m_cut >= m_total) & dl_clean
    admit = Q.admit_rows(p.bl_in, p.bl_out, p.dl_in, rows.dlo_u,
                         rows.blin_v, rows.blout_v, dl_on)
    ids = torch.arange(lo, lo + n_loc, device=dev)
    fr = ids[:, None] == u[None, :].long()                 # (n_loc, Qc)
    visited = fr.clone()
    hit = torch.zeros(qc, dtype=torch.bool, device=dev)
    owns_v = (v >= lo) & (v < lo + n_loc)
    vloc = (v.long() - lo).clamp(0, n_loc - 1)
    lanes = torch.arange(qc, device=dev)
    cut = m_cut.long()
    edge_ok = live[dp.e_gid] & dp.e_valid
    state = _lane_state(mesh, fr, hit)
    it = 0
    while it < max_iters and bool((state[0] > 0) & ~hit.all()):
        sf = dp.h_valid[..., None] & fr[dp.h_send]         # (d, H, Qc)
        rf = _exchange(mesh, sf.to(torch.uint8))
        frc = torch.cat([fr, rf.reshape(d * H, qc).bool()])
        # the round's active entries: a frontier pusher, live, not padding
        eidx = torch.nonzero(frc.any(1)[dp.e_slot] & edge_ok).squeeze(1)
        contrib = frc[dp.e_slot[eidx]] & \
            (dp.e_gid[eidx][:, None] < cut[None, :])
        nxt = torch.zeros((n_loc, qc), dtype=ftype, device=dev)
        nxt.index_reduce_(0, dp.e_recv[eidx], contrib.to(ftype), "amax",
                          include_self=True)
        nxt = (nxt > 0) & admit & ~visited & ~hit[None, :]
        state = _lane_state(mesh, nxt, nxt[vloc, lanes] & owns_v)
        hit = hit | (state[1:] > 0)
        visited |= nxt
        fr = nxt
        it += 1
    return hit
