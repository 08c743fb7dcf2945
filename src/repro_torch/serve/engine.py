"""Batched query engine: Alg 2 as a serving product.

Most queries resolve from DL/BL labels alone; only the residue needs a
pruned BFS.  The engine keeps that pipeline on the device:

- **backend chosen once** from the device: ``"cuda"`` runs the
  hand-written verdict kernel (and, with ``bfs_kernel=True``, the admit
  plane kernel); ``"torch"`` runs the torch-op path on the CPU.  Asking for
  ``"torch"`` on a CUDA device raises: the card always serves through the
  kernels;
- **one label phase per batch**: verdicts, per-family attribution counts
  and an O(Q) cumsum/scatter compaction of the unknown lanes; the only
  host traffic a batch owes is one int32 (the unknown count), read once;
- **snapshot epochs and coalescing**: ``submit()`` tags a batch with the
  current epoch and edge count, ``insert()`` bumps the epoch without
  flushing, and ``flush()`` pools the residues of batches from different
  epochs into one chunked BFS against the newest graph.  Insert-only
  updates are monotone, so a per-lane edge-count cutoff keeps
  ``"as-of-submit"`` answers exact; ``"latest"`` lifts the cutoff;
- **adaptive flushing**: ``flush_policy="deadline"`` resolves once the
  oldest submit is older than ``flush_deadline_ms``; ``"watermark"`` once
  the pooled residue reaches ``flush_watermark`` lanes;
- **fully-dynamic serving**: ``delete()`` drains in-flight submits, then
  tombstones edges (the labels go dirty: positives and theorem negatives
  ride a live-edge BFS); ``rebuild()`` rebuilds the labels (full, delta or
  auto) and re-binds the engine to a new lineage;
- **streamed kernels**: ``streaming=True`` routes the verdicts and (with
  ``bfs_kernel``) the admit planes through the streamed kernels; on the
  CPU the ``"torch"`` backend takes their plain versions.  An index with
  the "il" family takes the grid verdict kernel instead (the streamed one
  has no interval operands), with one ``StreamILFallbackWarning`` per
  engine;
- **label families and word planes**: an "il" index adds its interval
  prune to the verdicts, the attribution's "il" column and the admit
  planes (off while the labels are dirty), and its insert hook runs with
  every insert; ``plane_repr="packed"`` runs the insert and rebuild
  fixpoints on int32 words and ``frontier_dtype="packed"`` the residue BFS
  on words of 32 query lanes, all bitwise equal to the defaults;
- **AOT cold starts**: ``aot_warmup(index, cache_dir)`` loads the label
  phase and, for each chunk bucket, the coalesced residue's prologue and
  BFS round as ``torch.export`` programs from a disk cache
  (``serve.aot``), and exports the ones it misses for the next process.
  ``submit`` calls the label phase through ``_label_phase`` and the
  residue through ``_coal_phases[bucket]``: the live methods, or
  dispatchers that route exact input shapes to the loaded programs.  The
  dirty flag is an input of every phase (a 0-d bool tensor, ``d_stale``),
  as in the reference, so one program serves clean and dirty labels.  The
  BFS loop stays on the host between rounds.  Answers are bitwise the
  same either way;
- **dispatch shapes**: ``dispatch_shape_counts()`` counts the distinct
  input signatures the label phase and the coalesced residue (one entry a
  chunk bucket's signature) were dispatched with: what a jit cache, a
  CUDA graph pool or an export cache must hold.  ``warmup(index,
  batch_sizes, bfs_buckets)`` dispatches each of them once with dead
  lanes and loads the kernels, so the first served round, clean or dirty,
  builds nothing.

**Query-axis serving** (``mesh=``, a ``distributed.query_mesh`` or a
launch mesh, ``launch.mesh.make_mesh_compat``, whose axes are flattened;
SPMD over ``torch.distributed``, every rank holding the whole replicated
index, ``launch.sharding.reach_place_index``, and making the same calls):
the label phase splits each batch's lanes into one contiguous block a
rank, runs the verdict kernel (grid or
streamed, as the replicated engine would) on its block and all-gathers
the (Q,) verdicts (``distributed.fan_out``); the residue, inserts,
deletes and rebuilds run replicated on every rank, with the admit kernels
under ``bfs_kernel=True``.  Answers and stats equal the replicated
engine's.

**Vertex-sharded serving** (``vertex_mesh=``, SPMD over
``torch.distributed``, one process a shard, every rank making the same
calls): the bound index is row-sharded (a replicated index is placed, a
shard is taken as it is) with a shard plan for its edges.  The label
phase and the coalesced re-check read the eight verdict row blocks (and
the four interval rows) rebuilt on every rank by one ``all_reduce`` each
(``planes.sharded_rows``); the residue runs ``planes.sharded_pruned_bfs``
on the row-sharded planes.  No kernel is on this path, as in the
reference, and ``bfs_kernel=True``, ``backend="cuda"`` and ``streaming``
are refused (the engine's backend is ``"torch"``).  Inserts
extend the plan, deletes keep the layout, rebuilds hand their plan to the
re-bind.  Answers and stats are bitwise equal to the replicated engine's.
``halo_mode="sparse"`` runs its insert and rebuild fixpoints through the
sparse halo (``core.halo``), ``hub_count`` gives its plans a hub lane and
``halo_caps`` overrides the sparse capacities; ``halo_stats()`` reads the
modeled halo bytes and rounds (zero on the other layouts).
"""
from __future__ import annotations

import contextlib
import functools
import time
import warnings
import weakref
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core import graph as G
from repro_torch.core import halo as HL
from repro_torch.core import planes as PL
from repro_torch.core import query as Q
from repro_torch.core import update as U
from repro_torch.core.propagate import check_halo_mode, check_plane_repr
from repro_torch.core.dbl import (DBLIndex, LabelSaturationWarning,
                                  _saturation_message)
from repro_torch.device import resolve_device
from repro_torch.kernels.bfs_prune.ops import admit_plane
from repro_torch.kernels.bfs_relax.bfs_relax import waits_on_host
from repro_torch.kernels.dbl_query.ops import (StreamILFallbackWarning,
                                               verdicts_device)
from repro_torch.launch.mesh import Mesh
from repro_torch.tracing import span

#: supported consistency modes (``"latest-snapshot"`` is an alias)
CONSISTENCY_MODES = ("as-of-submit", "latest")

#: engine-initiated flush policies (``None`` = flush only when asked)
FLUSH_POLICIES = (None, "deadline", "watermark")


def select_backend(backend: str, device: torch.device) -> str:
    """Resolve ``"auto"``: the CUDA kernels on a CUDA device, torch ops on
    the CPU.  The torch path is refused on CUDA and the kernels on CPU."""
    want = "cuda" if device.type == "cuda" else "torch"
    if backend == "auto":
        return want
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != want:
        raise ValueError(f"backend {backend!r} does not run on {device}; "
                         f"use backend='auto' or {want!r}")
    return backend


def select_consistency(mode: str) -> str:
    if mode == "latest-snapshot":
        return "latest"
    if mode not in CONSISTENCY_MODES:
        raise ValueError(f"unknown consistency mode {mode!r}; "
                         f"expected one of {CONSISTENCY_MODES}")
    return mode


@dataclass
class EngineStats:
    queries: int = 0
    label_answered: int = 0
    bfs_answered: int = 0
    batches: int = 0
    inserts: int = 0
    deletes: int = 0          # delete-batch pairs tombstoned
    rebuilds: int = 0         # label rebuilds (dirty -> clean)
    delta_rebuilds: int = 0   # rebuilds served by the delta path
    bfs_dispatches: int = 0
    flushes: int = 0
    policy_flushes: int = 0   # flushes initiated by the adaptive policy
    stale_lanes: int = 0      # residue lanes resolved across an epoch gap
    saturation_events: int = 0  # inserts whose label fixpoint hit max_iters
    #: the vertex-sharded halo's modeled wire bytes, rounds and all-quiet
    #: (pair, round) slots, mirrored from the engine's telemetry by
    #: ``QueryEngine.halo_stats()``; zero on the other layouts
    halo_bytes: int = 0
    halo_rounds: int = 0
    quiet_pair_rounds: int = 0
    #: per-family attribution over every resolved lane: "dl" label
    #: positives (incl. self-queries), "bl"/"il" negatives charged to BL /
    #: interval containment, "thm" the theorem-1/2 negatives, "bfs" the
    #: residue lanes; the values sum to ``queries``.
    prune_hits: dict = field(default_factory=lambda: {
        "dl": 0, "bl": 0, "il": 0, "thm": 0, "bfs": 0})

    def as_dict(self) -> dict:
        rho = self.label_answered / max(self.queries, 1)
        return {"queries": self.queries, "rho": rho,
                "batches": self.batches, "inserts": self.inserts,
                "deletes": self.deletes, "rebuilds": self.rebuilds,
                "delta_rebuilds": self.delta_rebuilds,
                "bfs_dispatches": self.bfs_dispatches,
                "flushes": self.flushes,
                "policy_flushes": self.policy_flushes,
                "stale_lanes": self.stale_lanes,
                "saturation_events": self.saturation_events,
                "halo_bytes": self.halo_bytes,
                "halo_rounds": self.halo_rounds,
                "quiet_pair_rounds": self.quiet_pair_rounds,
                "prune_hits": dict(self.prune_hits)}


def _go(go: torch.Tensor) -> bool:
    """The residue loop's 0-d ``go`` on the host: one read a BFS round."""
    with span("repro_torch.sync.bfs_go"):
        return bool(go)


def _to_card(x: np.ndarray, device, site: str) -> torch.Tensor:
    """``x`` copied to ``device``, in the host wait's ``sync`` span."""
    with span(site):
        return torch.from_numpy(x).to(device)


def _to_host(x: torch.Tensor, site: str) -> np.ndarray:
    """``x`` read back as numpy, in the host wait's ``sync`` span."""
    with span(site):
        return x.cpu().numpy()


class _Pending:
    """Handle for a submitted batch: label phase done, BFS deferred.

    ``lineage``/``epoch``/``m_at_submit`` tag the snapshot the batch
    observed; engine-bound pendings resolve against the engine's newest
    index with a per-lane edge-count cutoff."""

    __slots__ = ("engine", "index", "q", "answers", "order",
                 "u_c", "v_c", "n_unknown", "counts",
                 "lineage", "epoch", "m_at_submit", "t_submit",
                 "_result", "_nu", "__weakref__")

    def __init__(self, engine, index, q, answers, order, u_c, v_c, n_unknown,
                 counts=None, lineage=None, epoch=None, m_at_submit=None,
                 t_submit=None):
        self.engine = engine
        self.index = index
        self.q = q
        self.answers = answers
        self.order = order
        self.u_c = u_c
        self.v_c = v_c
        self.n_unknown = n_unknown
        self.counts = counts      # (4,) [dl+, bl-, il-, thm-] on the device
        self.lineage = lineage
        self.epoch = epoch
        self.m_at_submit = m_at_submit
        self.t_submit = t_submit
        self._result = None
        self._nu = None

    @property
    def nu(self) -> int:
        """Unknown-lane count, read from the device once per batch."""
        if self._nu is None:
            with span("repro_torch.sync.n_unknown"):
                self._nu = min(int(self.n_unknown), self.q)
        return self._nu

    def resolve(self) -> np.ndarray:
        if self._result is None:
            self._result = self.engine._finish(self)
        return self._result


class QueryEngine:
    """Stateless core (``run``) plus optional bound-index serving state
    (``query``/``insert`` mutate the bound index; ``submit``/``flush`` form
    the pipeline that rides across inserts)."""

    def __init__(self, index: DBLIndex | None = None, *,
                 bfs_chunk: int = 256, max_iters: int = 256,
                 backend: str = "auto", q_block: int = 512,
                 mesh=None, vertex_mesh=None, bfs_kernel: bool = False,
                 streaming: bool = False, donate: str | bool = "auto",
                 consistency: str = "as-of-submit",
                 frontier_dtype: str = "int8", out_dtype: str = "int8",
                 plane_repr: str = "bool", halo_mode: str = "dense",
                 hub_count: int = 0, halo_caps: tuple | None = None,
                 flush_policy: str | None = None,
                 flush_deadline_ms: float = 25.0,
                 flush_watermark: int = 256, device=None):
        if bfs_chunk <= 0 or q_block <= 0:
            raise ValueError("bfs_chunk and q_block must be positive")
        if mesh is not None and vertex_mesh is not None:
            raise ValueError(
                "mesh (query-axis fan-out, labels replicated) and "
                "vertex_mesh (vertex-sharded labels) are mutually "
                "exclusive engine layouts")
        if isinstance(mesh, Mesh):
            mesh = D.flat_query_mesh(mesh)
        if mesh is not None and not (isinstance(mesh, D.VertexMesh)
                                     and mesh.axis == D.QUERY_AXIS):
            raise TypeError(
                "mesh= takes a query mesh, "
                "repro_torch.core.distributed.query_mesh(), or a launch "
                "mesh, not "
                f"{type(mesh).__name__}"
                + (" over the vertex axis (pass it as vertex_mesh=)"
                   if isinstance(mesh, D.VertexMesh) else ""))
        if frontier_dtype not in Q.FRONTIER_DTYPES:
            raise ValueError(f"unknown frontier dtype {frontier_dtype!r}; "
                             f"expected one of {list(Q.FRONTIER_DTYPES)}")
        if frontier_dtype == "packed" and vertex_mesh is not None:
            raise ValueError(
                "frontier_dtype='packed' packs the query-lane axis of the "
                "replicated BFS only; the vertex-sharded residue keeps its "
                "per-lane frontier planes (use 'int8'/'int32')")
        if streaming and vertex_mesh is not None:
            raise ValueError(
                "the vertex-sharded layout reconstructs verdict row blocks "
                "with collectives and never dispatches the query kernels; "
                "streaming=True would be dead there")
        if vertex_mesh is not None and (bfs_kernel
                                        or backend not in ("auto", "torch")):
            raise ValueError(
                "no kernel is on the vertex-sharded path: its verdicts and "
                "admit blocks run as torch ops on the rebuilt row blocks, "
                "so bfs_kernel=True and backend="
                f"{backend!r} would never launch (use backend='auto')")
        check_plane_repr(plane_repr)
        check_halo_mode(halo_mode)
        if hub_count < 0:
            raise ValueError("hub_count must be non-negative")
        if halo_caps is not None and (
                not halo_caps or any(int(c) <= 0 for c in halo_caps)):
            raise ValueError("halo_caps must be a non-empty tuple of "
                             "positive bucket capacities (or None = auto)")
        if out_dtype not in ("int8", "int32"):
            raise ValueError(f"unknown verdict out dtype {out_dtype!r}; "
                             "expected 'int8' or 'int32'")
        if flush_policy not in FLUSH_POLICIES:
            raise ValueError(f"unknown flush policy {flush_policy!r}; "
                             f"expected one of {FLUSH_POLICIES}")
        if flush_deadline_ms <= 0 or flush_watermark <= 0:
            raise ValueError("flush_deadline_ms and flush_watermark must "
                             "be positive")
        self.mesh = mesh
        self.vertex_mesh = vertex_mesh
        self.layout = "vertex_sharded" if vertex_mesh is not None \
            else "replicated"
        if vertex_mesh is not None:
            self.device = vertex_mesh.device
        elif mesh is not None and index is None:
            self.device = mesh.device
        elif index is not None:
            self.device = index.device
        else:
            self.device = resolve_device(device)
        self.bfs_chunk = int(bfs_chunk)
        self.max_iters = int(max_iters)
        self._backend_request = backend
        # the sharded path runs torch ops on whatever card its mesh holds
        self.backend = "torch" if vertex_mesh is not None \
            else select_backend(backend, self.device)
        # kept for the reference's signature; the kernels mask their ragged
        # tail, so nothing pads to it
        self.q_block = int(q_block)
        self.bfs_kernel = bool(bfs_kernel)
        self.streaming = bool(streaming)
        # per-engine latch: a streaming engine given interval planes warns
        # once that its verdicts take the grid kernel
        self._stream_il_warned = False
        self.consistency = select_consistency(consistency)
        self.frontier_dtype = frontier_dtype
        self.plane_repr = plane_repr
        self.out_dtype = out_dtype
        self._out_torch = torch.int8 if out_dtype == "int8" else torch.int32
        # the vertex-sharded fixpoints' halo exchange (inert on the other
        # layouts): "sparse" runs the insert and rebuild fixpoints through
        # core.halo, hub_count gives the plans a hub lane, halo_caps
        # overrides the sparse capacities (None: halo.bucket_caps(H))
        self.halo_mode = halo_mode
        self.hub_count = int(hub_count)
        self.halo_caps = None if halo_caps is None \
            else tuple(int(c) for c in halo_caps)
        self._halo_telemetry = HL.HaloTelemetry()
        self.flush_policy = flush_policy
        self.flush_deadline_ms = float(flush_deadline_ms)
        self.flush_watermark = int(flush_watermark)
        self._clock = time.monotonic     # monkeypatchable in policy tests
        if donate == "auto":
            donate = self.device.type == "cuda" and vertex_mesh is None
        # donate: inserts rewrite the bound index's label planes in place
        self.donate = bool(donate)
        self.stats = EngineStats()
        self.last_rebuild_info: dict | None = None   # set by rebuild()
        # the dispatch points of the query phases: the live methods, or
        # aot_warmup's ShapeDispatchers over them; _coal_phases maps a
        # chunk bucket to its (prologue, round) pair
        self._label_phase = self.label_phase
        self._coal_phases: dict = {}
        # the distinct dispatch signatures of each query phase
        self._shapes: dict = {"label": set(), "bfs": set()}
        # (graph, the graph as the residue phases take it), for the last
        # graph a dispatch read (_phase_graph); (graph, label_del_epoch,
        # the 0-d dirty gate) for the last index state (_dirty_gate)
        self._phase_g = None
        self._phase_gate = None
        self.aot_cache = None                        # set by aot_warmup()
        # the sharded layout's plan for the bound edges; rebuild() hands
        # its plan to the re-bind through _plan_override
        self._plan: PL.ShardPlan | None = None
        self._plan_override: PL.ShardPlan | None = None
        # lineage tells re-binds apart from in-place epoch bumps
        self._lineage = 0
        self._index: DBLIndex | None = None
        self.epoch = 0
        self._m_now = 0
        self._inflight: list = []
        self._sat_flags: list = []
        if index is not None:
            self.index = index

    # ------------------------------------------------------------ binding
    @property
    def index(self) -> DBLIndex | None:
        return self._index

    @index.setter
    def index(self, idx: DBLIndex | None):
        """(Re-)bind a serving index: starts a new snapshot lineage.
        In-flight submits of the outgoing lineage resolve first.  The
        engine follows the index's device.  A vertex-sharded engine
        places a replicated index on its mesh, takes a shard of its mesh
        as it is, and plans the bound edges (or adopts the plan a
        ``rebuild()`` made for exactly them)."""
        if idx is not None and idx.scheme is not None:
            raise self._scheme_index()
        if idx is not None and self.vertex_mesh is not None:
            idx = self._place(idx)
        elif idx is not None and idx.layout.sharded:
            raise self._unsharded_engine()
        if self._index is not None:
            self._drain_inflight()
        self._lineage += 1
        # consumed whatever happens below: a stale plan never survives to
        # a later re-bind
        override, self._plan_override = self._plan_override, None
        if idx is not None and self.vertex_mesh is not None:
            if override is not None and override.m == idx.graph.m \
                    and override.n_cap == idx.n_cap:
                self._plan = override
            else:
                g = idx.graph
                self._plan = PL.shard_plan(g.src, g.dst, g.m, idx.n_cap,
                                           self.vertex_mesh,
                                           hub_count=self.hub_count)
        self._index = idx
        if idx is not None:
            if idx.device != self.device:
                self.device = idx.device
                if self.vertex_mesh is None:
                    self.backend = select_backend(self._backend_request,
                                                  self.device)
            self.epoch = int(idx.epoch)
            self._m_now = int(idx.graph.m)
        else:
            self.epoch = 0
            self._m_now = 0
            self._plan = None

    @staticmethod
    def _unsharded_engine() -> ValueError:
        return ValueError(
            "a vertex-sharded index is served by a vertex-sharded engine: "
            "QueryEngine(index, vertex_mesh=mesh)")

    @staticmethod
    def _scheme_index() -> ValueError:
        return ValueError(
            "an index of the auto-partitioned scheme is served whole: "
            "repro_torch.launch.sharding.reach_place_index(index, mesh)")

    def _place(self, idx: DBLIndex) -> DBLIndex:
        """``idx`` as a shard of this engine's mesh."""
        want = PL.vertex_layout(self.vertex_mesh)
        if not idx.layout.sharded:
            return D.place_vertex_sharded(idx, self.vertex_mesh)
        if idx.layout != want:
            raise ValueError(f"the shard's layout {idx.layout} is not this "
                             f"rank's on the engine's mesh ({want})")
        return idx

    def _drain_inflight(self):
        stale = self._unresolved_inflight()
        if stale:
            self.flush(stale)
        self._inflight = []

    def _check_device(self, index: DBLIndex):
        if self.vertex_mesh is not None and index is not self._index:
            # the shard plan covers the bound lineage's edges only, so a
            # foreign snapshot is refused at submit, not at flush
            raise ValueError(
                "vertex-sharded engines serve only their bound index; "
                "bind the snapshot first (engine.index = idx)")
        if index.scheme is not None:
            raise self._scheme_index()
        if self.vertex_mesh is None and index.layout.sharded:
            raise self._unsharded_engine()
        if index.device != self.device:
            raise ValueError(f"index lives on {index.device}, engine on "
                             f"{self.device}")

    # ------------------------------------------------------------ phases
    def _verdict_streaming(self, il) -> bool:
        """Whether a verdict dispatch takes the streamed kernel.  With
        interval planes it takes the grid kernel, and the engine warns
        ``StreamILFallbackWarning`` once (the ops-level warning then stays
        quiet for it)."""
        if self.streaming and il is not None:
            if not self._stream_il_warned:
                self._stream_il_warned = True
                warnings.warn(
                    "streaming engine given interval-family planes: "
                    "verdict dispatches fall back to the grid kernel "
                    "(bitwise-identical verdicts); the streamed dbl_query "
                    "kernel takes no interval-family operands",
                    StreamILFallbackWarning, stacklevel=3)
            return False
        return self.streaming

    def _verdicts(self, p: Q.PackedLabels, u, v, m_cut, m_total, d_cut,
                  il=None):
        """Cutoff verdicts: the kernel on CUDA, its plain version on the
        CPU, with the tombstone cutoff ``d_cut`` (``_d_cut``: two
        freshness rows in either state); ``il`` is the optional interval
        operand."""
        return verdicts_device(p, u, v, m_cut, m_total, *d_cut, il,
                               out_dtype=self._out_torch,
                               streaming=self._verdict_streaming(il))

    @staticmethod
    def _d_cut(u, clean: torch.Tensor):
        """(d_cut, d_total), the reference's ``_d_cut_vec``: a per-lane
        tombstone cutoff from the 0-d gate ``clean`` (``~d_stale``), 0 < 1
        on every lane when dirty and 1 >= 1 when clean, so that one
        program serves both states.  Contiguous int32, as the kernels'
        wrappers take it."""
        return clean.expand(u.shape).to(torch.int32), 1

    @staticmethod
    def _gate(d_stale, device) -> torch.Tensor:
        """``d_stale`` as the phases read it: a 0-d bool tensor (a host
        bool is put on ``device``)."""
        if isinstance(d_stale, torch.Tensor):
            return d_stale
        return torch.full((), bool(d_stale), dtype=torch.bool, device=device)

    def _dirty_gate(self, index: DBLIndex) -> torch.Tensor:
        """``index.is_dirty`` as the 0-d bool tensor the phases take as
        ``d_stale``, filled on the index's device (no copy from the host).
        Made once for each index state (its graph and the deletions its
        labels cover), not on every dispatch."""
        st = self._phase_gate
        if st is None or st[0] is not index.graph \
                or st[1] != index.label_del_epoch:
            st = self._phase_gate = (index.graph, index.label_del_epoch,
                                     self._gate(index.is_dirty,
                                                index.device))
        return st[2]

    def label_phase(self, p: Q.PackedLabels, u: torch.Tensor,
                    v: torch.Tensor, d_stale, il=None):
        """Verdicts, attribution counts and the compaction of unknown
        lanes.  ``d_stale`` is the index's dirty flag, a 0-d bool tensor
        (or a host bool): with pending tombstones only self-positives and
        BL negatives answer from labels.  ``il`` is the index's optional
        (il_in, il_out) interval operand: a negative rule on clean labels,
        nothing while dirty, and the attribution's "il" column.
        Compaction is an O(Q) cumsum/scatter, not a sort: unknown lanes
        keep submission order at slots [0, nu), known lanes fill the tail,
        and endpoints are scattered straight to their slots.  A
        vertex-sharded engine reads the row blocks rebuilt by one
        ``all_reduce`` (two with ``il``); a query-mesh engine runs its
        block of the lanes and all-gathers the verdicts once.  No layout
        reads the gate on the host."""
        clean = ~self._gate(d_stale, u.device)
        if self.vertex_mesh is not None:
            rows, il_rows = self._sharded_rows(p, il, u, v)
            verd = Q.cut_verdicts_rows(rows, u, v, 1, 0, clean,
                                       il_rows=il_rows)
        elif self.mesh is not None:
            def block(a, b):
                fresh = torch.full(a.shape, Q.FRESH_CUT, dtype=torch.int32,
                                   device=a.device)
                return self._verdicts(p, a, b, fresh, 0,
                                      self._d_cut(a, clean), il)
            verd = D.fan_out(self.mesh, block, u, v)
            rows, il_rows = Q.gather_rows(p, u, v), Q.gather_il_rows(il, u, v)
        else:
            fresh = torch.full(u.shape, Q.FRESH_CUT, dtype=torch.int32,
                               device=u.device)
            verd = self._verdicts(p, u, v, fresh, 0, self._d_cut(u, clean),
                                  il)
            rows, il_rows = Q.gather_rows(p, u, v), Q.gather_il_rows(il, u, v)
        counts = Q.verdict_counts(verd, rows, il_rows)
        unknown = verd == -1
        n_unknown = unknown.sum().to(torch.int32)
        rank_u = torch.cumsum(unknown.to(torch.int32), 0)
        rank_k = torch.cumsum((~unknown).to(torch.int32), 0)
        pos = torch.where(unknown, rank_u - 1, n_unknown + rank_k - 1).long()
        q = u.shape[0]
        lanes = torch.arange(q, dtype=torch.int32, device=u.device)
        order = torch.zeros(q, dtype=torch.int32, device=u.device)
        order[pos] = lanes
        u_c = torch.zeros_like(order)
        u_c[pos] = u
        v_c = torch.zeros_like(order)
        v_c[pos] = v
        return verd == 1, order, u_c, v_c, n_unknown, counts

    def _sharded_rows(self, p, il, u, v):
        """(row blocks, interval rows or None) rebuilt on every rank."""
        mesh = self.vertex_mesh
        return (PL.sharded_rows(p, u, v, mesh=mesh),
                None if il is None else PL.sharded_il_rows(il, u, v,
                                                           mesh=mesh))

    def coalesced_phase(self, index: DBLIndex, uu, vv, m_cut, d_stale,
                        min_rounds: int = 0) -> torch.Tensor:
        """One chunk of an epoch-coalesced residue: re-check the lanes
        against the newest labels (verdict 0 → False, surviving +1 → True;
        stale-lane positives were downgraded by the cutoff), then run the
        cutoff BFS on the lanes still unknown.  Dead lanes (padding)
        carry ``u = n_cap`` and never extend the BFS.  An "il" index adds
        its prune to the re-check and, on clean labels, to the admit
        planes (the sharded residue skips it there: the prune is sound,
        so the hits are the same).  ``d_stale`` is the 0-d dirty gate
        (``_dirty_gate``), read on the device by every layout.  The
        replicated residue runs at least ``min_rounds`` BFS rounds
        (``warmup``: a round on dead lanes changes nothing)."""
        g, p, il = index.graph, index.packed, index.il
        n_cap = index.n_cap
        self._shapes["bfs"].add(self._bfs_shape(g, p, il, uu))
        if self.vertex_mesh is not None:
            clean = ~self._gate(d_stale, uu.device)
            live_lane = uu < n_cap
            uu_safe = uu.clamp(max=n_cap - 1)
            rows, il_rows = self._sharded_rows(p, il, uu_safe, vv)
            verd = Q.cut_verdicts_rows(rows, uu_safe, vv, m_cut, g.m,
                                       clean, il_rows=il_rows)
            need = live_lane & (verd == -1)
            uu2 = torch.where(need, uu, torch.full_like(uu, n_cap))
            hit = PL.sharded_pruned_bfs(
                self._plan, p, rows, uu2, vv, G.edge_mask(g), m_cut, g.m,
                clean, max_iters=self.max_iters,
                frontier_dtype=self.frontier_dtype)
            return ((verd == 1) & live_lane) | hit
        c = uu.shape[0]
        prologue, round_ = self._coal_phases.get(
            c, (self.coalesced_prologue, self.coalesced_round))
        with span("repro_torch.query.residue.chunk"):
            known, carry, consts, go = prologue(self._phase_graph(g), p, il,
                                                uu, vv, m_cut, d_stale)
            # the plain relax's one read a round, the count of its
            # frontier's edges, lies inside the round torch.export takes
            # whole; the relax kernel reads nothing, so no span opens
            edges = span if waits_on_host(uu.device) else \
                contextlib.nullcontext
            it = 0
            while it < self.max_iters and (it < min_rounds or _go(go)):
                with span("repro_torch.query.residue.round"), \
                        edges("repro_torch.sync.bfs_edges"):
                    carry, go = round_(carry, consts)
                it += 1
            return known | Q.bfs_hits(carry, c, self.frontier_dtype)

    def _phase_graph(self, g: G.Graph) -> G.Graph:
        """``g`` with ``m`` and ``del_epoch`` as 0-d int32 tensors, filled
        on its device (no copy from the host): the residue phases read
        them as inputs, so an exported program serves every edge count.
        Made once for each graph (a Graph is never changed in place: an
        insert or delete makes a new one), not on every dispatch."""
        if self._phase_g is None or self._phase_g[0] is not g:
            def scalar(x):
                return torch.full((), x, dtype=torch.int32, device=g.device)
            self._phase_g = (g, replace(g, m=scalar(g.m),
                                        del_epoch=scalar(g.del_epoch)))
        return self._phase_g[1]

    def coalesced_prologue(self, g: G.Graph, p: Q.PackedLabels, il, uu, vv,
                           m_cut, d_stale):
        """The replicated residue up to its first BFS round: the re-check
        verdicts (the cutoff verdict kernel), the admit plane (the admit
        kernel under ``bfs_kernel``, its interval term gated by
        ``~d_stale``) and ``Q.bfs_prologue``.  Returns
        (lanes the re-check answers True, carry, consts, go).  Only
        tensors come in (``g`` as ``_phase_graph`` gives it, ``d_stale``
        as ``_dirty_gate`` does; a host bool is taken too) and go out, so
        that ``torch.export`` takes it whole."""
        n_cap = p.dl_in.shape[0]
        clean = ~self._gate(d_stale, uu.device)
        d_cut = self._d_cut(uu, clean)
        live_lane = uu < n_cap
        uu_safe = uu.clamp(max=n_cap - 1)
        verd = self._verdicts(p, uu_safe, vv, m_cut, g.m, d_cut, il)
        need = live_lane & (verd == -1)
        uu2 = torch.where(need, uu, torch.full_like(uu, n_cap))
        admit = None
        if self.bfs_kernel:
            admit = admit_plane(p, uu2.clamp(max=n_cap - 1), vv, m_cut, g.m,
                                *d_cut, il, clean, out_dtype=torch.int8,
                                device=self.device.type,
                                streaming=self.streaming)
        carry, consts, go = Q.bfs_prologue(
            g, p, uu2, vv, admit, m_cut, clean, il, n_cap=n_cap,
            frontier_dtype=self.frontier_dtype)
        return (verd == 1) & live_lane, carry, consts, go

    def coalesced_round(self, carry, consts):
        """One BFS round of the replicated residue (``Q.bfs_round``)."""
        return Q.bfs_round(carry, consts, frontier_dtype=self.frontier_dtype)

    # the dispatch keys of the query phases (``aot.ShapeDispatcher``): what
    # varies between one engine's calls of a phase.  Dtypes, the frontier
    # layout and the other knobs are fixed by the engine's configuration
    # (the cache key holds them); the dirty gate is an input, as in the
    # reference, so one program serves both states.
    @classmethod
    def _label_key(cls, p, u, v, d_stale, il):
        return cls._label_shape(p, u, il)

    @staticmethod
    def _prologue_key(g, p, il, uu, vv, m_cut, d_stale):
        return (uu.shape[0], m_cut is None, g.src.shape, p.dl_in.shape,
                p.bl_in.shape, None if il is None else il[0].shape)

    @staticmethod
    def _round_key(carry, consts):
        return (carry[0].shape, consts[1].shape, consts[4] is None)

    # the dispatch shapes (``dispatch_shape_counts``): the input signature
    # of a label phase and of a chunk bucket's residue, as the reference's
    # jit caches key them.  The dirty flag is an input (one program serves
    # both states), so it is not part of the signature; a vertex-sharded
    # residue takes the plan's padded routing tables as inputs, so their
    # extents are.
    @staticmethod
    def _label_shape(p, u, il):
        return (u.shape[0], p.dl_in.shape, p.bl_in.shape,
                None if il is None else il[0].shape)

    def _bfs_shape(self, g, p, il, uu):
        plan = None if self.vertex_mesh is None else (
            self._plan.fwd.e_recv.shape, self._plan.fwd.h_send.shape)
        return (uu.shape[0], g.src.shape, p.dl_in.shape, p.bl_in.shape,
                None if il is None else il[0].shape, plan)

    def insert_impl(self, idx: DBLIndex, ns, nd) -> tuple[DBLIndex, bool]:
        """Alg 3 on the bound index: the fused DL/BL update, then the "il"
        hook over the extended graph.  Returns (next index, whether a
        fixpoint saturated)."""
        g2, a, b, c, d, iters, epoch2 = U.insert_and_update(
            idx.graph, idx.dl_in, idx.dl_out, idx.bl_in, idx.bl_out, ns, nd,
            self.epoch, n_cap=idx.n_cap, max_iters=self.max_iters,
            plane_repr=self.plane_repr, inplace=self.donate)
        il_kw = {}
        if idx.il_in is not None:
            with span("repro_torch.insert.il"):
                il_in, il_out, it_il = U.insert_update_plugin(
                    "il", g2, idx.il_in, idx.il_out, ns, nd,
                    n_cap=idx.n_cap, max_iters=self.max_iters)
            il_kw = dict(il_in=il_in, il_out=il_out)
            iters = iters + it_il
        sat = U.saturated(iters, self.max_iters)
        # direct field write: an insert advances the epoch within the
        # current lineage (the property setter would start a new one)
        nxt = replace(idx, graph=g2, dl_in=a, dl_out=b, bl_in=c, bl_out=d,
                      packed=Q.pack_labels(a, b, c, d), epoch=epoch2,
                      saturated=idx.saturated or sat, **il_kw)
        return nxt, sat

    def _chunk_buckets(self):
        sizes, c = [], 16
        while c < self.bfs_chunk:
            sizes.append(c)
            c *= 2
        sizes.append(self.bfs_chunk)
        return sizes

    def _bucket_for(self, nu: int) -> int:
        for c in self._chunk_buckets():
            if nu <= c:
                return c
        return self.bfs_chunk

    # ------------------------------------------------------------ queries
    def _padded(self, q: int) -> int:
        c = self.bfs_chunk
        return max(c, -(-int(q) // c) * c)

    def _pad_queries(self, u, v):
        u = np.asarray(u, np.int32).ravel()
        v = np.asarray(v, np.int32).ravel()
        q = u.shape[0]
        qp = self._padded(q)
        if qp != q:
            # pad with self-queries on vertex 0: verdict +1, never unknown
            u = np.pad(u, (0, qp - q))
            v = np.pad(v, (0, qp - q))
        return (_to_card(u, self.device, "repro_torch.sync.query_input"),
                _to_card(v, self.device, "repro_torch.sync.query_input"), q)

    def submit(self, index: DBLIndex, u, v) -> _Pending:
        """Run the label phase now; the BFS is deferred to ``resolve()`` /
        ``flush()``.  Submits against the bound index are tagged with the
        current epoch and edge count and survive later ``insert()``s."""
        self._check_device(index)
        with span("repro_torch.query.label"):
            uj, vj, q = self._pad_queries(u, v)
            self._shapes["label"].add(self._label_shape(index.packed, uj,
                                                        index.il))
            answers, order, u_c, v_c, n_unknown, counts = self._label_phase(
                index.packed, uj, vj, self._dirty_gate(index), index.il)
        if self._index is not None and index is self._index:
            tag = dict(lineage=self._lineage, epoch=self.epoch,
                       m_at_submit=self._m_now)
        else:
            tag = {}
        pend = _Pending(self, index, q, answers, order, u_c, v_c, n_unknown,
                        counts, t_submit=self._clock(), **tag)
        if tag:
            self._inflight = [r for r in self._inflight
                              if r() is not None and r()._result is None]
            self._inflight.append(weakref.ref(pend))
            self.maybe_flush()
        return pend

    # ------------------------------------------------- adaptive flushing
    def _unresolved_inflight(self) -> list:
        return [p for p in (r() for r in self._inflight)
                if p is not None and p._result is None
                and p.lineage == self._lineage]

    def flush_due(self) -> bool:
        """Whether the adaptive policy wants the pipeline resolved now.
        On an engine over a mesh every rank must flush together, and the
        deadline reads each rank's own clock: the ranks agree by one
        ``all_reduce(MAX)`` of the flag (the watermark counts pooled
        residue lanes, equal on every rank already)."""
        if self.flush_policy is None:
            return False
        pending = self._unresolved_inflight()
        if not pending:
            return False
        if self.flush_policy == "deadline":
            oldest = min(p.t_submit for p in pending)
            due = (self._clock() - oldest) * 1e3 >= self.flush_deadline_ms
            return self._agreed(due)
        return sum(p.nu for p in pending) >= self.flush_watermark

    def _agreed(self, flag: bool) -> bool:
        """``flag`` on any rank of an engine over a mesh (either axis);
        ``flag`` on a replicated one."""
        mesh = self.vertex_mesh or self.mesh
        if mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        return bool(t.item())

    def maybe_flush(self) -> bool:
        """Run the adaptive flush policy once; True when a flush ran."""
        if not self.flush_due():
            return False
        self.flush(self._unresolved_inflight())
        self.stats.policy_flushes += 1
        return True

    def _current_lineage(self, p: _Pending) -> bool:
        return (p.engine is self and p.lineage is not None
                and p.lineage == self._lineage and self._index is not None)

    def _finish(self, pend: _Pending) -> np.ndarray:
        results: dict[int, np.ndarray] = {}
        self._finish_group([(0, pend)], results, self.consistency,
                           self._current_lineage(pend))
        return results[0]

    def flush(self, pendings, *, consistency: str | None = None) -> list:
        """Resolve submitted batches together, pooling their BFS residues
        across snapshot epochs into one chunked dispatch sequence against
        the newest index.  Per-lane edge-count cutoffs keep as-of-submit
        answers exact; ``consistency="latest"`` lifts them."""
        mode = select_consistency(consistency or self.consistency)
        results: dict[int, np.ndarray] = {}
        groups: dict[tuple, list] = {}
        for i, p in enumerate(pendings):
            if p._result is not None:
                results[i] = p._result
                continue
            if self._current_lineage(p):
                key = ("lineage", self._lineage)
            else:
                key = ("index", id(p.index.packed.dl_in))
            groups.setdefault(key, []).append((i, p))
        for key, grp in groups.items():
            self._finish_group(grp, results, mode, key[0] == "lineage")
        self.stats.flushes += 1
        if self._sat_flags:
            self.check_saturation()
        return [results[i] for i in range(len(pendings))]

    def _finish_group(self, grp, results, mode, engine_group):
        with span("repro_torch.query.residue"):
            self._resolve_group(grp, results, mode, engine_group)

    def _resolve_group(self, grp, results, mode, engine_group):
        infos = [(i, p, p.nu) for i, p in grp]
        total = sum(nu for _, _, nu in infos)
        hits_all = np.zeros(0, np.bool_)
        if total:
            if self.vertex_mesh is not None and not engine_group:
                raise ValueError(
                    "vertex-sharded engines resolve only batches submitted "
                    "against their bound index (the shard plan covers its "
                    "lineage only)")
            index = self._index if engine_group else grp[0][1].index
            n_cap = index.n_cap
            uu = np.concatenate([
                _to_host(p.u_c[:nu], "repro_torch.sync.residue_lanes")
                for _, p, nu in infos if nu])
            vv = np.concatenate([
                _to_host(p.v_c[:nu], "repro_torch.sync.residue_lanes")
                for _, p, nu in infos if nu])
            if engine_group and mode == "as-of-submit":
                cuts = np.concatenate([
                    np.full(nu, p.m_at_submit, np.int32)
                    for _, p, nu in infos if nu])
                self.stats.stale_lanes += int((cuts < self._m_now).sum())
            else:
                # latest consistency / foreign snapshot: every lane sees
                # the group's full edge set and keeps the DL prune
                cuts = np.full(total, Q.FRESH_CUT, np.int32)
            chunk = (self.bfs_chunk if total > self.bfs_chunk
                     else self._bucket_for(total))
            pad = -total % chunk
            if pad:
                uu = np.concatenate([uu, np.full(pad, n_cap, np.int32)])
                vv = np.concatenate([vv, np.zeros(pad, np.int32)])
                cuts = np.concatenate([cuts,
                                       np.full(pad, Q.FRESH_CUT, np.int32)])
            dev = self.device
            gate = self._dirty_gate(index)
            hit_parts = []
            for start in range(0, total, chunk):
                sl = slice(start, start + chunk)
                uc, vc, cc = [_to_card(x[sl], dev,
                                       "repro_torch.sync.residue_input")
                              for x in (uu, vv, cuts)]
                hit_parts.append(self.coalesced_phase(index, uc, vc, cc,
                                                      gate))
                self.stats.bfs_dispatches += 1
            hits_all = _to_host(torch.cat(hit_parts),
                                "repro_torch.sync.hits")[:total]
        off = 0
        for i, p, nu in infos:
            ans = _to_host(p.answers, "repro_torch.sync.answers").copy()
            if nu:
                order = _to_host(p.order[:nu], "repro_torch.sync.order")
                ans[order] = hits_all[off:off + nu]
                off += nu
            out = ans[:p.q]
            p._result = out
            results[i] = out
            self.stats.queries += p.q
            self.stats.batches += 1
            self.stats.bfs_answered += nu
            self.stats.label_answered += p.q - nu
            if p.counts is not None:
                # padding lanes are vertex-0 self-queries, charged to "dl"
                # by the label phase; back them out
                with span("repro_torch.sync.counts"):
                    dl, bl, il, thm = (int(x) for x in p.counts.cpu())
                pad = int(p.answers.shape[0]) - p.q
                ph = self.stats.prune_hits
                ph["dl"] += dl - pad
                ph["bl"] += bl
                ph["il"] += il
                ph["thm"] += thm
                ph["bfs"] += nu

    def run(self, index: DBLIndex, u, v, *, return_stats: bool = False):
        """Full Alg 2 on ``index`` for one batch; returns (Q,) np.bool_."""
        q = int(np.asarray(u).size)
        if q == 0:
            ans = np.zeros(0, np.bool_)
            return (ans, {"rho": 1.0, "n_bfs": 0}) if return_stats else ans
        with span("repro_torch.query"):
            pend = self.submit(index, u, v)
            ans = pend.resolve()
        if return_stats:
            nu = pend.nu
            return ans, {"rho": 1.0 - nu / q, "n_bfs": nu}
        return ans

    # ------------------------------------------------------ bound serving
    def query(self, u, v, *, return_stats: bool = False):
        if self._index is None:
            raise ValueError("engine has no bound index; use run()")
        return self.run(self._index, u, v, return_stats=return_stats)

    def insert(self, new_src, new_dst) -> DBLIndex:
        """Insert edges into the bound index (Alg 3), bumping the snapshot
        epoch.  Outstanding submits are not flushed: they resolve later
        against the newest snapshot with their cutoffs.  With ``donate``
        the previous snapshot's label planes are rewritten in place, so
        callers must not keep using the old index."""
        if self._index is None:
            raise ValueError("engine has no bound index; use run()")
        ns = np.asarray(new_src, np.int32).ravel()
        nd = np.asarray(new_dst, np.int32).ravel()
        with span("repro_torch.insert"):
            if self.vertex_mesh is not None:
                # sharded Alg 3; the plan is extended to the appended edges
                idx2, self._plan, sat = D.insert_vertex_sharded(
                    self._index, self._plan, ns, nd,
                    max_iters=self.max_iters, check="defer",
                    plane_repr=self.plane_repr, halo_mode=self.halo_mode,
                    halo_caps=self.halo_caps,
                    telemetry=self._halo_telemetry)
                self._index = replace(idx2, epoch=self.epoch + 1)
            else:
                site = "repro_torch.sync.insert_input"
                self._index, sat = self.insert_impl(
                    self._index, _to_card(ns, self.device, site),
                    _to_card(nd, self.device, site))
        self._sat_flags.append(sat)   # surfaced at flush boundaries
        self.epoch += 1
        self._m_now += int(ns.size)
        self.stats.inserts += int(ns.size)
        return self._index

    def delete(self, del_src, del_dst) -> DBLIndex:
        """Tombstone every live edge matching a (src, dst) pair, without
        label recomputation: the bound index goes (or stays) dirty until
        ``rebuild()``.  In-flight submits are drained first: the lanes they
        hold observed the edge set before the delete, which the dirty
        index's live-edge BFS no longer sees.  A shard keeps its layout,
        and the engine its plan: tombstones do not change the plan."""
        if self._index is None:
            raise ValueError("engine has no bound index; use run()")
        with span("repro_torch.delete"):
            self._drain_inflight()
            idx = self._index
            ds = np.asarray(del_src, np.int32).ravel()
            dd = np.asarray(del_dst, np.int32).ravel()
            g2, epoch2 = U.delete_and_mark(idx.graph, ds, dd, self.epoch)
            self._index = replace(idx, graph=g2, epoch=epoch2)
        self.epoch += 1
        self.stats.deletes += int(ds.size)
        return self._index

    def rebuild(self, **build_kw) -> DBLIndex:
        """Label rebuild over the live edge set (``DBLIndex.rebuild_info``;
        ``mode`` "full" by default, "delta" or "auto"), then a re-bind to
        the rebuilt index, which resolves in-flight submits of the
        outgoing lineage first: compaction renumbers edge slots, so their
        edge-count cutoffs mean nothing in the new one.  The path that ran
        is kept in ``last_rebuild_info``.  A vertex-sharded engine runs
        ``rebuild_vertex_sharded`` and hands its plan to the re-bind."""
        if self._index is None:
            raise ValueError("engine has no bound index; use run()")
        build_kw.setdefault("max_iters", self.max_iters)
        build_kw.setdefault("plane_repr", self.plane_repr)
        if self.vertex_mesh is not None:
            build_kw.setdefault("halo_mode", self.halo_mode)
            build_kw.setdefault("halo_caps", self.halo_caps)
            build_kw.setdefault("telemetry", self._halo_telemetry)
            new_idx, plan, info = D.rebuild_vertex_sharded(
                self._index, self._plan, mesh=self.vertex_mesh, **build_kw)
            self._plan_override = plan   # the setter adopts it
        else:
            new_idx, info = self._index.rebuild_info(**build_kw)
        self.index = new_idx      # property setter: drain + new lineage
        self.stats.rebuilds += 1
        if info["mode"] == "delta":
            self.stats.delta_rebuilds += 1
        self.last_rebuild_info = info
        return new_idx

    def halo_stats(self) -> dict:
        """The halo telemetry's counts (modeled wire bytes, rounds by
        regime, quiet and non-quiet pair rounds, fixpoints), with the
        headline three mirrored into ``stats``; all zero unless the engine
        is vertex-sharded."""
        d = self._halo_telemetry.as_dict()
        self.stats.halo_bytes = d["halo_bytes"]
        self.stats.halo_rounds = d["halo_rounds"]
        self.stats.quiet_pair_rounds = d["quiet_pair_rounds"]
        return d

    # ------------------------------------------------------------- AOT
    def aot_warmup(self, index: DBLIndex, cache_dir, *,
                   batch_sizes=(1,), bfs_buckets=None) -> "QueryEngine":
        """Warm the query phases from an AOT disk cache of
        ``torch.export`` programs (``serve.aot``): the label phase for each
        batch size (padded to a multiple of ``bfs_chunk``) and, for each chunk
        bucket, the coalesced residue's prologue and one BFS round.  Hits
        go behind the dispatch points; misses export this process's phases
        so that the next process hits.  Each phase is exported once, with
        every lane fresh and the index's 0-d dirty gate (``_dirty_gate``)
        as an input, as the reference exports it: a loaded program serves
        clean and dirty dispatches, and only another shape runs the live
        phase.  Answers are bitwise the same either way.  Replicated layout
        only: a mesh engine's collectives are bound to its process group,
        so mesh engines refuse."""
        from repro_torch.serve.aot import AOTCache, ShapeDispatcher
        if self.vertex_mesh is not None or self.mesh is not None:
            raise ValueError("the AOT cache supports the replicated "
                             "single-process layout only")
        self._check_device(index)
        cache = AOTCache(cache_dir)
        self.aot_cache = cache
        config = self._aot_config(index)
        # a streaming engine given interval planes warns here, hit or miss
        self._verdict_streaming(index.il)

        def entry(tag, dispatcher, fn, args):
            key = cache.key(tag, self.backend, args, config=config)
            prog = cache.load(key, tag)
            if prog is None:
                cache.store(key, fn, args, tag)
            else:
                dispatcher.add(args, prog)

        if not isinstance(self._label_phase, ShapeDispatcher):
            self._label_phase = ShapeDispatcher(self._label_phase,
                                                self._label_key)
        i32 = dict(dtype=torch.int32, device=index.device)
        gate = self._dirty_gate(index)
        for q in batch_sizes:
            qp = self._padded(q)
            entry("label", self._label_phase, self.label_phase,
                  (index.packed, torch.zeros(qp, **i32),
                   torch.zeros(qp, **i32), gate, index.il))
        g = self._phase_graph(index.graph)
        for chunk in (bfs_buckets or self._chunk_buckets()):
            c = self._bucket_for(chunk)
            if c not in self._coal_phases:
                self._coal_phases[c] = (
                    ShapeDispatcher(self.coalesced_prologue,
                                    self._prologue_key),
                    ShapeDispatcher(self.coalesced_round, self._round_key))
            prologue, round_ = self._coal_phases[c]
            args = (g, index.packed, index.il,
                    torch.full((c,), index.n_cap, **i32),
                    torch.zeros(c, **i32),
                    torch.full((c,), Q.FRESH_CUT, **i32), gate)
            entry(f"coalesced-{c}", prologue, self.coalesced_prologue, args)
            # the round's inputs as a loaded prologue hands them over
            _, carry, consts, _ = self.coalesced_prologue(*args)
            entry(f"bfs-round-{c}", round_, self.coalesced_round,
                  (carry, consts))
        return self

    def _aot_config(self, index: DBLIndex) -> dict:
        """The AOT key's config: every knob a program bakes in beyond its
        input shapes, since a hit under other knobs would serve the old
        semantics (a smaller max_iters, another frontier layout).  The
        families and the interval draw are in it too: dim-equal planes
        from another rank seed have the same shapes."""
        return {"max_iters": self.max_iters, "q_block": self.q_block,
                "bfs_chunk": self.bfs_chunk, "bfs_kernel": self.bfs_kernel,
                "streaming": self.streaming,
                "frontier_dtype": self.frontier_dtype,
                "out_dtype": self.out_dtype,
                "plane_repr": self.plane_repr,
                "halo_mode": self.halo_mode,
                "hub_count": self.hub_count,
                "halo_caps": None if self.halo_caps is None
                else list(self.halo_caps),
                "families": list(index.families),
                "il_dim": index.il_dim,
                "il_seed": None if index.il_seed is None
                else int(index.il_seed)}

    # ------------------------------------------------------ introspection
    def dispatch_shape_counts(self) -> dict:
        """Distinct input signatures by phase: ``"label"`` (batch size
        padded to a multiple of ``bfs_chunk``, the plane shapes, the
        interval planes) and ``"bfs"`` (one a chunk bucket's signature,
        its prologue and its rounds together), as the reference counts
        its jit cache entries.  The reference pads a batch to a multiple
        of ``lcm(q_block, bfs_chunk)``, so on a stream of many batch
        sizes the port can count more label signatures."""
        return {k: len(v) for k, v in self._shapes.items()}

    def dispatch_shapes(self) -> int:
        """Number of distinct input signatures behind query dispatches."""
        c = self.dispatch_shape_counts()
        return c["label"] + c["bfs"]

    def _kernel_libraries(self, index: DBLIndex) -> list:
        """The kernel libraries this engine's phases launch on ``index``."""
        if self.backend != "cuda":
            return []
        names = ["dbl_query_streamed"
                 if self.streaming and index.il is None else "dbl_query"]
        if self.bfs_kernel:
            names.append("bfs_prune_streamed" if self.streaming
                         else "bfs_prune")
        return names

    def warmup(self, index: DBLIndex, batch_sizes=(1,),
               bfs_buckets=None) -> "QueryEngine":
        """Build and load the kernels the phases launch
        (``kernels._build``), then dispatch the label phase for each batch
        size and the coalesced residue for each chunk bucket (default the
        ``bfs_chunk`` one) with dead lanes and the index's dirty gate, as
        serving dispatches them, with one BFS round, which dead lanes
        would skip: the reference compiles the loop's body with its phase,
        and here a live lane's first round would pay the round's first
        launches.  The gate is an input, so the one dispatch warms clean
        and dirty rounds alike.  On a mesh every rank calls it."""
        from repro_torch.kernels import _build
        self._check_device(index)
        for name in self._kernel_libraries(index):
            _build.load(name)
        for q in batch_sizes:
            self.submit(index, np.zeros(q, np.int32), np.zeros(q, np.int32))
        i32 = dict(dtype=torch.int32, device=index.device)
        for chunk in (bfs_buckets or (self.bfs_chunk,)):
            c = self._bucket_for(chunk)
            self.coalesced_phase(index, torch.full((c,), index.n_cap, **i32),
                                 torch.zeros(c, **i32),
                                 torch.full((c,), Q.FRESH_CUT, **i32),
                                 self._dirty_gate(index), min_rounds=1)
        return self

    def check_saturation(self, *, warn: bool = True) -> int:
        """Drain the deferred per-insert saturation flags and return how
        many insert batches saturated; optionally warns.  Runs at every
        ``flush()``."""
        flags, self._sat_flags = self._sat_flags, []
        n = sum(bool(f) for f in flags)
        if n:
            self.stats.saturation_events += n
            if warn:
                warnings.warn(_saturation_message(self.max_iters),
                              LabelSaturationWarning, stacklevel=2)
        return n


@functools.lru_cache(maxsize=64)
def engine_for(*, bfs_chunk: int, max_iters: int, backend: str = "auto",
               q_block: int = 512, device: str = "cuda") -> QueryEngine:
    """Memoized stateless engines, so ``DBLIndex.query`` reuses one engine
    per configuration and device (indexes are per-call arguments)."""
    return QueryEngine(None, bfs_chunk=bfs_chunk, max_iters=max_iters,
                       backend=backend, q_block=q_block, donate=False,
                       device=device)
