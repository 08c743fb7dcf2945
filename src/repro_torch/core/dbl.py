"""DBLIndex: the public API of the paper's contribution.

    idx = DBLIndex.build(g, n_cap=..., k=64, k_prime=64)   # Alg 1
    ans = idx.query(u, v)                                  # Alg 2
    idx = idx.insert_edges(src, dst)                       # Alg 3 (batched)
    idx = idx.delete_edges(src, dst)       # tombstones, labels go dirty
    idx = idx.rebuild(mode="auto")         # label rebuild over live edges

Bool planes (n_cap, k) uint8 are the source of truth; packed int32 words
are kept in sync and feed the query path and the kernels.
``plane_repr="packed"`` runs every OR fixpoint (build, insert, rebuild) on
the words instead, with bitwise-equal planes.  ``families`` adds plug-in
label families to the fused ("dl", "bl") core (``core.families``): the
"il" interval family stores two (n_cap, 2*dim) int32 planes and the seed
it re-draws them from.  ``layout`` says whose rows the planes hold: the
whole index (``planes.REPLICATED``) or one rank's row block of a
vertex-sharded index (``core.distributed``), on which the methods that
need whole planes raise.  ``from_numpy``/``to_numpy`` carry an index to
and from the reference's field names.

**Two sharded forms.**  A *vertex-sharded* index (``layout`` a
``"vertex_sharded"`` layout, ``distributed.build_vertex_sharded``) holds
its rank's row block of the planes and everything else whole, and runs
every lifecycle step with halo exchanges; a method that needs whole
planes raises and names the sharded counterpart.  An index of the
*auto-partitioned* scheme (``scheme``, the launch mesh it lives on;
``distributed.shard_index``/``distributed_build``) holds its rank's block
of every array leaf, as ``distributed.index_shardings`` lays them out:
plane rows, the leaf masks and the edge arrays split over every mesh
axis, flattened.  Its ``layout`` stays ``REPLICATED``.  ``insert_edges``
runs ``distributed.distributed_insert``, ``delete_edges`` tombstones each
rank's edge block, ``label_verdicts`` runs
``distributed.distributed_label_verdicts``, and the other methods gather
the index at entry (every rank makes the call), as the reference's
partitioner gathers for the unmodified code; results come back in the
same scheme.

**Fully-dynamic mode.**  ``delete_edges`` stamps tombstones and leaves the
labels as a sound over-approximation; while dirty (``graph.del_epoch`` is
ahead of ``label_del_epoch``) queries downgrade DL positives and the
theorem negatives to a live-edge BFS, and BL negatives stay valid.
``rebuild`` clears the dirty state: ``"full"`` re-runs Alg 1 over the live
edges, ``"delta"`` resets only the label entries a deleted edge (or
landmark/leaf churn) could have invalidated and re-runs the monotone
fixpoint from there, reaching the same least fixpoint bit for bit, and
``"auto"`` picks by the invalidation estimate.  A saturated index always
rebuilds in full.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import resolve_device
from . import bitset
from . import families as F
from . import graph as G
from . import labels as L
from . import planes as PL
from . import propagate as P
from . import query as Q
from . import select as S
from . import update as U

DEFAULT_FAMILIES = F.DEFAULT_FAMILIES


class LabelSaturationWarning(UserWarning):
    """A label fixpoint hit max_iters without converging: labels are stale
    and queries may return FALSE negatives until a rebuild."""


class LabelSaturationError(RuntimeError):
    """Strict-mode variant of LabelSaturationWarning."""


def _saturation_message(max_iters) -> str:
    return (f"label propagation hit max_iters={max_iters} without "
            "converging: labels are stale and queries may return wrong "
            "answers. Re-run with a larger max_iters or rebuild() the index.")


def _check_mode(check: str) -> None:
    if check not in ("warn", "raise", "defer"):
        raise ValueError(f"unknown check mode {check!r}")


def _surface(sat: bool, check: str, max_iters: int) -> None:
    if check != "defer" and sat:
        if check == "raise":
            raise LabelSaturationError(_saturation_message(max_iters))
        warnings.warn(_saturation_message(max_iters),
                      LabelSaturationWarning, stacklevel=3)


not_ported = PL.not_ported


_PLANES = ("dl_in", "dl_out", "bl_in", "bl_out")

#: what serves a shard's queries
_SERVE_SHARD = ("repro_torch.serve.engine.QueryEngine(index, "
                "vertex_mesh=mesh), the same calls on every rank")


def _host_reach(src: np.ndarray, dst: np.ndarray, live: np.ndarray,
                seeds: np.ndarray) -> np.ndarray:
    """(n_cap,) bool: host reachability closure of ``seeds`` over the
    ``live`` edges (inclusive), a level-synchronous numpy BFS.  The CPU
    twin of ``propagate.reach_mask``; the delta plan takes this one for
    an index on the CPU and ``reach_mask`` on the card."""
    reach = seeds.copy()
    frontier = seeds.copy()
    n = seeds.shape[0]
    while frontier.any():
        hit = np.zeros(n, bool)
        hit[dst[live & frontier[src]]] = True
        frontier = hit & ~reach
        reach |= frontier
    return reach


@dataclass
class DBLIndex:
    graph: G.Graph
    landmarks: torch.Tensor     # (k,) int32
    dl_in: torch.Tensor         # (n_cap, k)  uint8 plane
    dl_out: torch.Tensor
    bl_in: torch.Tensor         # (n_cap, k') uint8 plane
    bl_out: torch.Tensor
    packed: Q.PackedLabels      # int32 word views
    bl_sources: torch.Tensor    # (n_cap,) bool leaf masks BL was seeded with
    bl_sinks: torch.Tensor
    # snapshot epoch, bumped by every insert batch: (epoch, graph.m) names
    # the edge set this snapshot observed
    epoch: int = 0
    # the graph delete epoch the labels were last (re)built for
    label_del_epoch: int = 0
    # sticky: some fixpoint of this index hit max_iters
    saturated: bool = False
    # the "il" plug-in family: (n_cap, 2*dim) int32 [lo | -hi] interval
    # planes per direction and the int32 seed they are drawn from (None
    # for the default families)
    il_in: torch.Tensor | None = None
    il_out: torch.Tensor | None = None
    il_seed: int | None = None
    # whose rows the planes hold; n_cap, landmarks, the leaf masks and the
    # graph are whole on every shard
    layout: PL.PlaneLayout = PL.REPLICATED
    # the launch mesh of an auto-partitioned index, whose every array leaf
    # is this rank's block (``distributed.index_shardings``); None otherwise
    scheme: object = None

    @property
    def n_cap(self) -> int:
        parts = self.layout.shards if self.scheme is None else \
            self.scheme.size
        return self.dl_in.shape[0] * parts

    @property
    def k(self) -> int:
        return self.dl_in.shape[1]

    @property
    def k_prime(self) -> int:
        return self.bl_in.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dl_in.device

    @property
    def families(self) -> tuple[str, ...]:
        """Enabled label families, from what the index stores."""
        return F.CORE_FAMILIES + (("il",) if self.il_in is not None else ())

    @property
    def il(self):
        """The (il_in, il_out) verdict operand, or None."""
        return None if self.il_in is None else (self.il_in, self.il_out)

    @property
    def il_dim(self) -> int | None:
        return None if self.il_in is None else self.il_in.shape[-1] // 2

    @property
    def store(self) -> PL.PlaneStore:
        """A PlaneStore view of the label state (planes, landmarks, leaf
        masks) with the index's layout."""
        return PL.PlaneStore(self.dl_in, self.dl_out, self.bl_in,
                             self.bl_out, self.landmarks, self.bl_sources,
                             self.bl_sinks, layout=self.layout)

    def with_store(self, store: PL.PlaneStore, **kw) -> "DBLIndex":
        """The index with its label fields (and layout) taken from
        ``store``; the words are repacked."""
        return replace(self, dl_in=store.dl_in, dl_out=store.dl_out,
                       bl_in=store.bl_in, bl_out=store.bl_out,
                       landmarks=store.landmarks,
                       bl_sources=store.bl_sources,
                       bl_sinks=store.bl_sinks, packed=store.pack(),
                       layout=store.layout, **kw)

    @property
    def dirty_flag(self) -> torch.Tensor:
        """() bool tensor on the index's device: ``is_dirty``."""
        return torch.tensor(self.is_dirty, device=self.device)

    @property
    def is_dirty(self) -> bool:
        """Labels carry deletions not yet rebuilt into them."""
        return self.graph.del_epoch > self.label_del_epoch

    def _gathered(self) -> "DBLIndex":
        """The whole index of an auto-partitioned one, on every rank."""
        from . import distributed as D
        return D.gather_index(self)

    def _whole(self, what: str, counterpart: str | None = None) -> None:
        """Refuse a method that needs whole planes on a shard: it names
        the sharded counterpart, or says that there is none, and never
        gathers."""
        if not self.layout.sharded:
            return
        if counterpart is not None:
            raise ValueError(f"{what} on a vertex-sharded index: use "
                             f"{counterpart}")
        raise ValueError(f"{what} needs whole label planes, which the "
                         "vertex-sharded layout never gathers")

    # ---- construction (Alg 1) -------------------------------------------
    @staticmethod
    def build(g: G.Graph, *, n_cap: int, k: int = 64, k_prime: int = 64,
              selection: str = "product", leaf_r: int = 0,
              max_iters: int = 256, check: str = "warn",
              plane_repr: str = "bool", families=DEFAULT_FAMILIES,
              il_dim: int = F.DEFAULT_IL_DIM, il_seed: int = 0,
              device=None) -> "DBLIndex":
        """Alg 1 on ``device`` (default ``"cuda"``).  A build whose
        fixpoints hit ``max_iters`` sets ``saturated``; ``check`` then
        warns ("warn"), raises ``LabelSaturationError`` ("raise") or only
        records it ("defer").  ``plane_repr="packed"`` runs the OR
        fixpoints on int32 words (bitwise-equal planes).  ``families``
        enables plug-in families after the ("dl", "bl") core, each built
        through its own hooks; ``il_dim``/``il_seed`` parameterise "il"."""
        _check_mode(check)
        P.check_plane_repr(plane_repr)
        plugin_fams = F.plugins(families)
        g = g.to(resolve_device(device))
        landmarks = S.select_landmarks(g, n_cap=n_cap, k=k, method=selection)
        dl_in, dl_out, it_dl = L.build_dl(g, landmarks, n_cap=n_cap, k=k,
                                          max_iters=max_iters,
                                          plane_repr=plane_repr)
        sources, sinks = S.leaf_masks(g, n_cap=n_cap, leaf_r=leaf_r)
        bl_in, bl_out, it_bl = L.build_bl(g, sources, sinks, n_cap=n_cap,
                                          k_prime=k_prime,
                                          max_iters=max_iters,
                                          plane_repr=plane_repr)
        iters = it_dl + it_bl
        il_kw = {}
        for fam in plugin_fams:
            p_in, p_out, it_f = fam.build(g, n_cap=n_cap, dim=il_dim,
                                          seed=il_seed, max_iters=max_iters)
            il_kw = dict(il_in=p_in, il_out=p_out, il_seed=int(il_seed))
            iters = iters + it_f
        sat = U.saturated(iters, max_iters)
        _surface(sat, check, max_iters)
        return DBLIndex(g, landmarks, dl_in, dl_out, bl_in, bl_out,
                        Q.pack_labels(dl_in, dl_out, bl_in, bl_out),
                        sources, sinks, epoch=0,
                        label_del_epoch=g.del_epoch, saturated=sat, **il_kw)

    # ---- queries (Alg 2) --------------------------------------------------
    def query(self, u, v, *, bfs_chunk: int = 64, max_iters: int = 256,
              return_stats: bool = False, driver: str = "engine"):
        """Batched reachability.  ``driver="engine"`` runs the QueryEngine
        (fused label phase + compacted BFS chunks); ``driver="host"`` runs
        the host-side reference loop.  An auto-partitioned index is
        gathered first, on every rank."""
        if self.scheme is not None:
            return self._gathered().query(
                u, v, bfs_chunk=bfs_chunk, max_iters=max_iters,
                return_stats=return_stats, driver=driver)
        self._whole("query", _SERVE_SHARD)
        if driver == "host":
            return Q.query(self.graph, self.packed, u, v, n_cap=self.n_cap,
                           bfs_chunk=bfs_chunk, max_iters=max_iters,
                           return_stats=return_stats, dirty=self.is_dirty,
                           il=self.il)
        if driver != "engine":
            raise ValueError(f"unknown driver {driver!r}")
        from repro_torch.serve.engine import engine_for
        eng = engine_for(bfs_chunk=bfs_chunk, max_iters=max_iters,
                         device=str(self.device))
        return eng.run(self, u, v, return_stats=return_stats)

    def label_verdicts(self, u, v) -> torch.Tensor:
        """(Q,) int8 label-only verdicts; on an auto-partitioned index
        ``distributed.distributed_label_verdicts`` over its mesh."""
        if self.scheme is not None:
            from . import distributed as D
            return D.distributed_label_verdicts(self, self.scheme, u, v)
        self._whole("label_verdicts", _SERVE_SHARD)
        dev = self.device
        return Q.label_verdicts(
            self.packed, torch.as_tensor(u, dtype=torch.int32, device=dev),
            torch.as_tensor(v, dtype=torch.int32, device=dev), il=self.il)

    # ---- updates (Alg 3) --------------------------------------------------
    def insert_edges(self, new_src, new_dst, *, max_iters: int = 256,
                     check: str = "warn", plane_repr: str = "bool"
                     ) -> "DBLIndex":
        """Batched Alg-3 insert; returns the next snapshot.  ``check`` as in
        ``build``: a fixpoint cut off at ``max_iters`` leaves labels stale,
        so it warns, raises, or ("defer") only sets the sticky
        ``saturated`` flag.  Plug-in families run their insert hooks over
        the extended graph.  An auto-partitioned index runs
        ``distributed.distributed_insert`` (edge-partitioned rounds, bool
        planes whatever ``plane_repr`` says: the planes are equal)."""
        if self.scheme is not None:
            from . import distributed as D
            P.check_plane_repr(plane_repr)
            return D.distributed_insert(self, self.scheme, new_src, new_dst,
                                        max_iters=max_iters, check=check)
        self._whole("insert_edges",
                    "repro_torch.core.distributed.insert_vertex_sharded")
        _check_mode(check)
        dev = self.device
        ns = torch.as_tensor(np.asarray(new_src, np.int32), device=dev)
        nd = torch.as_tensor(np.asarray(new_dst, np.int32), device=dev)
        g2, dl_in, dl_out, bl_in, bl_out, iters, epoch2 = \
            U.insert_and_update(self.graph, self.dl_in, self.dl_out,
                                self.bl_in, self.bl_out, ns, nd, self.epoch,
                                n_cap=self.n_cap, max_iters=max_iters,
                                plane_repr=plane_repr)
        il_kw = {}
        for fam in F.plugins(self.families):
            il_in, il_out, it_f = U.insert_update_plugin(
                fam.name, g2, self.il_in, self.il_out, ns, nd,
                n_cap=self.n_cap, max_iters=max_iters)
            il_kw = dict(il_in=il_in, il_out=il_out)
            iters = iters + it_f
        sat_now = U.saturated(iters, max_iters)
        _surface(sat_now, check, max_iters)
        return replace(self, graph=g2, dl_in=dl_in, dl_out=dl_out,
                       bl_in=bl_in, bl_out=bl_out,
                       packed=Q.pack_labels(dl_in, dl_out, bl_in, bl_out),
                       epoch=epoch2, saturated=self.saturated or sat_now,
                       **il_kw)

    def delete_edges(self, del_src, del_dst) -> "DBLIndex":
        """Tombstone every live edge matching a (src, dst) pair: O(m) mask
        work, no label recomputation.  The returned index is dirty until
        ``rebuild()``.  On an auto-partitioned index each rank tombstones
        its block of the edge slots (a slot's fate is its own)."""
        if self.scheme is not None:
            from . import distributed as D
            return D.scheme_delete(self, del_src, del_dst)
        g2, epoch2 = U.delete_and_mark(
            self.graph, np.asarray(del_src, np.int32),
            np.asarray(del_dst, np.int32), self.epoch)
        return replace(self, graph=g2, epoch=epoch2)

    def rebuild(self, **kw) -> "DBLIndex":
        """Label rebuild over the live edge set; see ``rebuild_info``."""
        return self.rebuild_info(**kw)[0]

    def rebuild_info(self, *, mode: str = "full", selection: str = "product",
                     leaf_r: int = 0, max_iters: int = 256,
                     compact: bool = True, check: str = "warn",
                     delta_threshold: float = 0.99,
                     plane_repr: str = "bool") -> tuple["DBLIndex", dict]:
        """Lazy label rebuild over the live edge set, clearing the dirty
        state, plus a report ``info`` of what ran.

        ``mode="full"`` re-runs Alg 1; ``"delta"`` repairs only what a
        tombstone or landmark/leaf churn could have invalidated (bitwise
        equal to full); ``"auto"`` takes delta unless the estimated
        invalidated fraction exceeds ``delta_threshold``.  A saturated
        index rebuilds in full (truncated labels are no sound delta base).
        ``info["mode"]`` is the path that ran, ``info["reason"]`` one of
        ``"forced"``/``"estimate"``/``"saturated"``, and
        ``info["estimate"]`` the delta plan's estimate whenever one was
        computed.  ``compact`` squeezes tombstones out of the edge arrays
        (slots renumber: a rebuild starts a new snapshot lineage).  The
        snapshot epoch goes up by one; ``saturated`` reflects this
        rebuild's own fixpoints, surfaced by ``check`` as in ``build``.
        An auto-partitioned index is gathered, rebuilt on every rank and
        laid out on its mesh again."""
        if self.scheme is not None:
            from . import distributed as D
            idx, info = self._gathered().rebuild_info(
                mode=mode, selection=selection, leaf_r=leaf_r,
                max_iters=max_iters, compact=compact, check=check,
                delta_threshold=delta_threshold, plane_repr=plane_repr)
            return D.shard_index(idx, self.scheme), info
        self._whole("rebuild_info",
                    "repro_torch.core.distributed.rebuild_vertex_sharded")
        if mode not in ("full", "delta", "auto"):
            raise ValueError(f"unknown rebuild mode {mode!r}")
        P.check_plane_repr(plane_repr)
        _check_mode(check)
        full_kw = dict(selection=selection, leaf_r=leaf_r,
                       max_iters=max_iters, compact=compact, check=check,
                       plane_repr=plane_repr)
        if mode == "full":
            return self._full_rebuild(**full_kw), \
                {"mode": "full", "reason": "forced"}
        if self.saturated:
            return self._full_rebuild(**full_kw), \
                {"mode": "full", "reason": "saturated"}
        plan = self._delta_plan(selection=selection, leaf_r=leaf_r)
        est = plan["estimate"]
        if mode == "auto" and est["frac"] > delta_threshold:
            return self._full_rebuild(**full_kw), \
                {"mode": "full", "reason": "estimate", "estimate": est}
        idx = self._delta_rebuild(plan, max_iters=max_iters,
                                  compact=compact, check=check,
                                  plane_repr=plane_repr)
        reason = "forced" if mode == "delta" else "estimate"
        return idx, {"mode": "delta", "reason": reason, "estimate": est}

    def _full_rebuild(self, *, selection: str, leaf_r: int, max_iters: int,
                      compact: bool, check: str,
                      plane_repr: str = "bool") -> "DBLIndex":
        g = G.compact(self.graph) if compact else self.graph
        fam_kw = {}
        if self.il_in is not None:
            fam_kw = dict(families=self.families, il_dim=self.il_dim,
                          il_seed=self.il_seed)
        idx = DBLIndex.build(g, n_cap=self.n_cap, k=self.k,
                             k_prime=self.k_prime, selection=selection,
                             leaf_r=leaf_r, max_iters=max_iters, check=check,
                             plane_repr=plane_repr, device=self.device,
                             **fam_kw)
        return replace(idx, epoch=self.epoch + 1)

    def _delta_plan(self, *, selection: str, leaf_r: int) -> dict:
        """The invalidation closures per direction, the re-selected seed
        sets, the fresh-column masks and the invalidation estimate the
        auto policy reads.  The closures run on the host for an index on
        the CPU (``_host_reach``) and on the device otherwise
        (``reach_mask``, converging within ``n_cap`` rounds)."""
        g = self.graph
        n_cap, k, kp = self.n_cap, self.k, self.k_prime
        lde = self.label_del_epoch
        # the edge set the labels are an exact fixpoint over: everything
        # live now plus everything tombstoned since the last (re)build
        old_live = G.edge_mask(g, lde)
        deleted = G.deleted_since(g, lde)
        seeds_f = torch.zeros(n_cap, dtype=torch.bool, device=self.device)
        seeds_f[g.dst[deleted].long()] = True
        seeds_b = torch.zeros(n_cap, dtype=torch.bool, device=self.device)
        seeds_b[g.src[deleted].long()] = True
        if self.device.type == "cpu":
            s_np, d_np = g.src.numpy(), g.dst.numpy()
            live_np = old_live.numpy()
            dirty_fwd = torch.from_numpy(
                _host_reach(s_np, d_np, live_np, seeds_f.numpy()))
            dirty_bwd = torch.from_numpy(
                _host_reach(d_np, s_np, live_np, seeds_b.numpy()))
        else:
            dirty_fwd = P.reach_mask(g.src, g.dst, old_live, seeds_f,
                                     n_cap=n_cap, max_iters=n_cap)[0]
            dirty_bwd = P.reach_mask(g.src, g.dst, old_live, seeds_b,
                                     n_cap=n_cap, max_iters=n_cap,
                                     reverse=True)[0]
        landmarks = S.select_landmarks(g, n_cap=n_cap, k=k, method=selection)
        sources, sinks = S.leaf_masks(g, n_cap=n_cap, leaf_r=leaf_r)
        dl_fresh = ~(landmarks[:, None] == self.landmarks[None, :]).any(1)
        fresh_fwd = torch.cat([dl_fresh, L.bucket_churn(
            self.bl_sources, sources, k_prime=kp)]).cpu().numpy()
        fresh_bwd = torch.cat([dl_fresh, L.bucket_churn(
            self.bl_sinks, sinks, k_prime=kp)]).cpu().numpy()
        n_dirty_f = int(dirty_fwd.sum())
        n_dirty_b = int(dirty_bwd.sum())
        n = max(int(g.n), 1)
        rf = float(n_dirty_f) / n
        rb = float(n_dirty_b) / n

        # invalidated-entry fraction per plane (rows ∪ columns); the auto
        # policy reads the worst of the four
        def plane_frac(r, c):
            return r + c - r * c
        fracs = {
            "dl_in": plane_frac(rf, float(fresh_fwd[:k].mean())),
            "dl_out": plane_frac(rb, float(fresh_bwd[:k].mean())),
            "bl_in": plane_frac(rf, float(fresh_fwd[k:].mean())),
            "bl_out": plane_frac(rb, float(fresh_bwd[k:].mean())),
        }
        estimate = {
            "frac": max(fracs.values()),
            "plane_fracs": fracs,
            "dirty_fwd": n_dirty_f,
            "dirty_bwd": n_dirty_b,
            "fresh_cols_fwd": int(fresh_fwd.sum()),
            "fresh_cols_bwd": int(fresh_bwd.sum()),
            "dead_edges": int(G.dead_edge_count(g)),
        }
        return {"dirty_fwd": dirty_fwd.to(self.device),
                "dirty_bwd": dirty_bwd.to(self.device),
                "landmarks": landmarks, "sources": sources, "sinks": sinks,
                "estimate": estimate}

    def _delta_rebuild(self, plan: dict, *, max_iters: int, compact: bool,
                       check: str, plane_repr: str = "bool") -> "DBLIndex":
        """Execute a delta plan: one fused fixpoint per direction.  With
        fresh columns the pass relaxes the whole live edge set (churned
        lanes rebuild from their seeds in the same rounds); without, it
        relaxes only the live edges into the dirty region, since pushes
        into clean vertices change nothing.  Plug-in families re-draw their
        planes from the stored seed over the live edges (for "il" every
        dimension is churned by a deletion), so delta equals full."""
        g = self.graph
        n_cap, k = self.n_cap, self.k
        live = G.edge_mask(g)
        (x_fwd, x_bwd, fresh_fwd, fresh_bwd, seed_fwd, seed_bwd,
         fr_fwd, fr_bwd) = L.delta_plane_state(
            g, self.dl_in, self.dl_out, self.bl_in, self.bl_out,
            self.landmarks, plan["landmarks"], self.bl_sources,
            self.bl_sinks, plan["sources"], plan["sinks"],
            plan["dirty_fwd"], plan["dirty_bwd"],
            n_cap=n_cap, k=k, k_prime=self.k_prime)
        iters = []

        def run_direction(x, seed, fresh, dirty, frontier, reverse):
            if bool(fresh.any()):
                # fresh seeds must reach everywhere: the whole live edge
                # set, with the churned lanes' seed rows on the frontier
                fr = frontier | (seed.bool() & fresh[None, :]).any(1)
                es, ed, el = g.src, g.dst, live
            else:
                # exactly the live edges into the dirty region; the
                # reference pads this bucket to a power of two for XLA's
                # compiled shapes, and padded slots are dead edges that
                # change no plane and no round count
                target = g.src if reverse else g.dst
                sel = torch.nonzero(
                    live & dirty[target.clamp(0, n_cap - 1).long()]
                ).squeeze(1)
                fr = frontier
                es, ed = g.src[sel], g.dst[sel]
                el = torch.ones(sel.shape, dtype=torch.bool,
                                device=self.device)
            x, it = P.propagate(x, es, ed, el, fr, n_cap=n_cap,
                                max_iters=max_iters, reverse=reverse,
                                plane_repr=plane_repr, inplace=True)
            iters.append(it)
            return x

        x_fwd = run_direction(x_fwd, seed_fwd, fresh_fwd, plan["dirty_fwd"],
                              fr_fwd, False)
        x_bwd = run_direction(x_bwd, seed_bwd, fresh_bwd, plan["dirty_bwd"],
                              fr_bwd, True)
        g2 = G.compact(g) if compact else g
        il_kw = {}
        for fam in F.plugins(self.families):
            il_in, il_out, it_f = fam.rebuild(
                g2, n_cap=n_cap, dim=self.il_dim, seed=self.il_seed,
                max_iters=max_iters)
            il_kw = dict(il_in=il_in, il_out=il_out, il_seed=self.il_seed)
            iters += it_f
        sat = U.saturated(iters, max_iters)
        _surface(sat, check, max_iters)
        dl_in, bl_in = x_fwd[:, :k].contiguous(), x_fwd[:, k:].contiguous()
        dl_out, bl_out = x_bwd[:, :k].contiguous(), \
            x_bwd[:, k:].contiguous()
        return DBLIndex(g2, plan["landmarks"], dl_in, dl_out, bl_in, bl_out,
                        Q.pack_labels(dl_in, dl_out, bl_in, bl_out),
                        plan["sources"], plan["sinks"],
                        epoch=self.epoch + 1, label_del_epoch=g2.del_epoch,
                        saturated=sat, **il_kw)

    # ---- introspection ----------------------------------------------------
    def label_bytes(self) -> int:
        return sum(int(w.numel()) * 4 for w in self.packed)

    def density(self) -> dict:
        """Mean label bits per vertex row, per plane (float32, as in the
        reference)."""
        if self.scheme is not None:
            return self._gathered().density()
        self._whole("density")
        return {name: float(bitset.unpack(getattr(self.packed, name),
                                          getattr(self, name).shape[1])
                            .sum(-1).to(torch.float32).mean())
                for name in _PLANES}

    # ---- state exchange with the reference -------------------------------
    @staticmethod
    def from_numpy(arrays: dict, *, device=None) -> "DBLIndex":
        """Index from numpy arrays keyed by the reference index's field
        names (``graph.src``, ``graph.dst``, ``graph.n``, ``graph.m``,
        ``graph.del_at``, ``graph.del_epoch``, ``landmarks``, the four
        planes, ``bl_sources``, ``bl_sinks``, ``epoch``, ``label_del_epoch``,
        ``saturated``, and for an "il" index ``il_in``, ``il_out``,
        ``il_seed``).  The packed words are repacked here; when the dict
        also holds ``packed.<plane>`` (uint32 or int32 words) they must
        equal the repacked words bit for bit."""
        dev = resolve_device(device)

        def t(key, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(arrays[key]).astype(dtype)).to(dev)

        g = G.Graph(t("graph.src", np.int32), t("graph.dst", np.int32),
                    torch.tensor(int(arrays["graph.n"]), dtype=torch.int32,
                                 device=dev),
                    int(arrays["graph.m"]), t("graph.del_at", np.int32),
                    int(arrays["graph.del_epoch"]))
        planes = {name: t(name, np.uint8) for name in _PLANES}
        packed = Q.pack_labels(*(planes[n] for n in _PLANES))
        for name in _PLANES:
            key = f"packed.{name}"
            if key in arrays:
                want = np.asarray(arrays[key]).view(np.int32)
                got = getattr(packed, name).cpu().numpy()
                if not np.array_equal(got, want):
                    raise ValueError(f"{key} disagrees with the words "
                                     f"repacked from {name}")
        il_kw = {}
        if arrays.get("il_in") is not None:
            il_kw = dict(il_in=t("il_in", np.int32),
                         il_out=t("il_out", np.int32),
                         il_seed=int(arrays["il_seed"]))
        return DBLIndex(g, t("landmarks", np.int32), *planes.values(), packed,
                        t("bl_sources", np.bool_), t("bl_sinks", np.bool_),
                        epoch=int(arrays["epoch"]),
                        label_del_epoch=int(arrays["label_del_epoch"]),
                        saturated=bool(arrays["saturated"]), **il_kw)

    def to_numpy(self) -> dict:
        """Inverse of ``from_numpy``; packed words come out as uint32, the
        reference's word type.  An auto-partitioned index is gathered
        first."""
        if self.scheme is not None:
            return self._gathered().to_numpy()
        self._whole("to_numpy")
        g = self.graph
        out = {"graph.src": g.src, "graph.dst": g.dst, "graph.n": g.n,
               "graph.del_at": g.del_at, "landmarks": self.landmarks,
               "bl_sources": self.bl_sources, "bl_sinks": self.bl_sinks}
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for name in _PLANES:
            out[name] = getattr(self, name).cpu().numpy()
            out[f"packed.{name}"] = getattr(self.packed, name).cpu().numpy() \
                .view(np.uint32)
        out.update({"graph.m": np.int32(g.m),
                    "graph.del_epoch": np.int32(g.del_epoch),
                    "epoch": np.int32(self.epoch),
                    "label_del_epoch": np.int32(self.label_del_epoch),
                    "saturated": np.bool_(self.saturated)})
        if self.il_in is not None:
            out.update({"il_in": self.il_in.cpu().numpy(),
                        "il_out": self.il_out.cpu().numpy(),
                        "il_seed": np.int32(self.il_seed)})
        return out
