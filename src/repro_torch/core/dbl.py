"""DBLIndex: the public API of the paper's contribution.

    idx = DBLIndex.build(g, n_cap=..., k=64, k_prime=64)   # Alg 1
    ans = idx.query(u, v)                                  # Alg 2
    idx = idx.insert_edges(src, dst)                       # Alg 3 (batched)

Bool planes (n_cap, k) uint8 are the source of truth; packed int32 words
are kept in sync and feed the query path and the kernels.  This slice
serves the default label families ("dl", "bl") with the replicated layout
and bool planes; deletions, rebuilds and the "il" family come in later
slices and raise ``NotImplementedError`` here.  ``from_numpy``/``to_numpy``
carry an index to and from the reference's field names.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import resolve_device
from . import bitset
from . import graph as G
from . import labels as L
from . import query as Q
from . import select as S
from . import update as U

DEFAULT_FAMILIES = ("dl", "bl")


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


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error for a reference feature a later slice ports; ``where``
    names its ROADMAP.md queue entry."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, {where})")


_PLANES = ("dl_in", "dl_out", "bl_in", "bl_out")


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

    @property
    def n_cap(self) -> int:
        return self.dl_in.shape[0]

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
    def is_dirty(self) -> bool:
        """Labels carry deletions not yet rebuilt into them."""
        return self.graph.del_epoch > self.label_del_epoch

    # ---- construction (Alg 1) -------------------------------------------
    @staticmethod
    def build(g: G.Graph, *, n_cap: int, k: int = 64, k_prime: int = 64,
              selection: str = "product", leaf_r: int = 0,
              max_iters: int = 256, check: str = "warn",
              plane_repr: str = "bool", families=DEFAULT_FAMILIES,
              device=None) -> "DBLIndex":
        """Alg 1 on ``device`` (default ``"cuda"``).  A build whose
        fixpoints hit ``max_iters`` sets ``saturated``; ``check`` then
        warns ("warn"), raises ``LabelSaturationError`` ("raise") or only
        records it ("defer")."""
        _check_mode(check)
        if plane_repr != "bool":
            raise not_ported(f"plane_repr={plane_repr!r}", "queue 1, item 13")
        if tuple(families) != DEFAULT_FAMILIES:
            raise not_ported(f"label families {tuple(families)!r}",
                             "queue 1, item 12")
        g = g.to(resolve_device(device))
        landmarks = S.select_landmarks(g, n_cap=n_cap, k=k, method=selection)
        dl_in, dl_out, it_dl = L.build_dl(g, landmarks, n_cap=n_cap, k=k,
                                          max_iters=max_iters)
        sources, sinks = S.leaf_masks(g, n_cap=n_cap, leaf_r=leaf_r)
        bl_in, bl_out, it_bl = L.build_bl(g, sources, sinks, n_cap=n_cap,
                                          k_prime=k_prime,
                                          max_iters=max_iters)
        sat = U.saturated(it_dl + it_bl, max_iters)
        _surface(sat, check, max_iters)
        return DBLIndex(g, landmarks, dl_in, dl_out, bl_in, bl_out,
                        Q.pack_labels(dl_in, dl_out, bl_in, bl_out),
                        sources, sinks, epoch=0,
                        label_del_epoch=g.del_epoch, saturated=sat)

    # ---- queries (Alg 2) --------------------------------------------------
    def query(self, u, v, *, bfs_chunk: int = 64, max_iters: int = 256,
              return_stats: bool = False, driver: str = "engine"):
        """Batched reachability.  ``driver="engine"`` runs the QueryEngine
        (fused label phase + compacted BFS chunks); ``driver="host"`` runs
        the host-side reference loop."""
        if driver == "host":
            return Q.query(self.graph, self.packed, u, v, n_cap=self.n_cap,
                           bfs_chunk=bfs_chunk, max_iters=max_iters,
                           return_stats=return_stats, dirty=self.is_dirty)
        if driver != "engine":
            raise ValueError(f"unknown driver {driver!r}")
        from repro_torch.serve.engine import engine_for
        eng = engine_for(bfs_chunk=bfs_chunk, max_iters=max_iters,
                         device=str(self.device))
        return eng.run(self, u, v, return_stats=return_stats)

    def label_verdicts(self, u, v) -> torch.Tensor:
        dev = self.device
        return Q.label_verdicts(
            self.packed, torch.as_tensor(u, dtype=torch.int32, device=dev),
            torch.as_tensor(v, dtype=torch.int32, device=dev))

    # ---- updates (Alg 3) --------------------------------------------------
    def insert_edges(self, new_src, new_dst, *, max_iters: int = 256,
                     check: str = "warn", plane_repr: str = "bool"
                     ) -> "DBLIndex":
        """Batched Alg-3 insert; returns the next snapshot.  ``check`` as in
        ``build``: a fixpoint cut off at ``max_iters`` leaves labels stale,
        so it warns, raises, or ("defer") only sets the sticky
        ``saturated`` flag."""
        _check_mode(check)
        if plane_repr != "bool":
            raise not_ported(f"plane_repr={plane_repr!r}", "queue 1, item 13")
        dev = self.device
        ns = torch.as_tensor(np.asarray(new_src, np.int32), device=dev)
        nd = torch.as_tensor(np.asarray(new_dst, np.int32), device=dev)
        g2, dl_in, dl_out, bl_in, bl_out, iters, epoch2 = \
            U.insert_and_update(self.graph, self.dl_in, self.dl_out,
                                self.bl_in, self.bl_out, ns, nd, self.epoch,
                                n_cap=self.n_cap, max_iters=max_iters)
        sat_now = U.saturated(iters, max_iters)
        _surface(sat_now, check, max_iters)
        return replace(self, graph=g2, dl_in=dl_in, dl_out=dl_out,
                       bl_in=bl_in, bl_out=bl_out,
                       packed=Q.pack_labels(dl_in, dl_out, bl_in, bl_out),
                       epoch=epoch2, saturated=self.saturated or sat_now)

    def delete_edges(self, del_src, del_dst) -> "DBLIndex":
        raise not_ported("delete_edges", "queue 1, item 11")

    def rebuild(self, **kw) -> "DBLIndex":
        raise not_ported("rebuild", "queue 1, item 11")

    # ---- introspection ----------------------------------------------------
    def label_bytes(self) -> int:
        return sum(int(w.numel()) * 4 for w in self.packed)

    def density(self) -> dict:
        """Mean label bits per vertex row, per plane (float32, as in the
        reference)."""
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
        ``saturated``).  The packed words are repacked here; when the dict
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
        return DBLIndex(g, t("landmarks", np.int32), *planes.values(), packed,
                        t("bl_sources", np.bool_), t("bl_sinks", np.bool_),
                        epoch=int(arrays["epoch"]),
                        label_del_epoch=int(arrays["label_del_epoch"]),
                        saturated=bool(arrays["saturated"]))

    def to_numpy(self) -> dict:
        """Inverse of ``from_numpy``; packed words come out as uint32, the
        reference's word type."""
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
        return out
