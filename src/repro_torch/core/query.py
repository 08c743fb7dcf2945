"""Query processing (paper Algorithm 2), batched.

Phase 1, label verdicts over packed words:
  +1  reachable    (Lemma 1: DL_out(u) ∩ DL_in(v) ≠ ∅, or u == v)
   0  unreachable  (Lemma 2: BL containment violated; Theorem 1: DL says
                    v→u but not u→v; Theorem 2: u or v is landmark-covered
                    and DL said no)
  -1  unknown      → phase 2.
Phase 2, a batched BFS pruned by a per-query admit plane (Alg 2 lines
20/22), with queries as lanes of an (n_cap, Qc) frontier plane.

Row gathers clamp ids to ``[0, n_cap)``, as the reference's gathers do:
the engine's dead residue lanes carry ``u = n_cap``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bitset
from .graph import Graph, edge_mask
from .interval import il_negative

#: per-lane edge-count-cutoff sentinel, >= any reachable edge count: marks
#: a lane (or a padding lane) as always fresh.
FRESH_CUT = 2**31 - 1

#: element types of the BFS frontier: "int8"/"int32" for the segment-max
#: operand of the lane-wise loop, "packed" for the loop on int32 words (32
#: query lanes a word, ``bfs_round``); all give bitwise-identical
#: hits.
FRONTIER_DTYPES = {"int8": torch.int8, "int32": torch.int32,
                   "packed": torch.int32}


@dataclass
class PackedLabels:
    dl_in: torch.Tensor   # (n_cap, Wk)  int32 words
    dl_out: torch.Tensor  # (n_cap, Wk)
    bl_in: torch.Tensor   # (n_cap, Wk') int32 words
    bl_out: torch.Tensor  # (n_cap, Wk')

    def __iter__(self):
        return iter((self.dl_in, self.dl_out, self.bl_in, self.bl_out))


def pack_labels(dl_in, dl_out, bl_in, bl_out) -> PackedLabels:
    """The four 0/1 planes packed into int32 words, each equal to
    ``bitset.pack`` of its plane, through the op
    ``repro_torch::pack_label_planes``: one kernel launch for CUDA planes,
    ``bitset.pack`` for CPU planes."""
    # imported here: the kernels' modules import this one
    from repro_torch.kernels.pack_planes.pack_planes import pack_label_planes
    return PackedLabels(*pack_label_planes(dl_in, dl_out, bl_in, bl_out))


def rows(plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``plane[ids]`` with ids clamped into ``[0, n)``."""
    return plane[ids.clamp(0, plane.shape[0] - 1).long()]


@dataclass
class RowBlocks:
    """The eight gathered label rows every Alg-2 verdict rule reads."""
    dlo_u: torch.Tensor   # DL_out[u]  (Q, Wk)
    dli_v: torch.Tensor   # DL_in[v]
    dlo_v: torch.Tensor   # DL_out[v]
    dli_u: torch.Tensor   # DL_in[u]
    blin_u: torch.Tensor  # BL_in[u]   (Q, Wk')
    blin_v: torch.Tensor  # BL_in[v]
    blout_v: torch.Tensor  # BL_out[v]
    blout_u: torch.Tensor  # BL_out[u]


def gather_rows(p: PackedLabels, u: torch.Tensor, v: torch.Tensor
                ) -> RowBlocks:
    return RowBlocks(rows(p.dl_out, u), rows(p.dl_in, v), rows(p.dl_out, v),
                     rows(p.dl_in, u), rows(p.bl_in, u), rows(p.bl_in, v),
                     rows(p.bl_out, v), rows(p.bl_out, u))


def gather_il_rows(il, u: torch.Tensor, v: torch.Tensor):
    """The four (Q, 2*dim) interval rows of the "il" family, or None."""
    if il is None:
        return None
    il_in, il_out = il
    return (rows(il_out, u), rows(il_out, v), rows(il_in, u), rows(il_in, v))


def verdict_parts_rows(r: RowBlocks):
    """(pos_lbl, bl_neg, thm) evidence masks behind the four rules."""
    pos_lbl = bitset.intersect_any(r.dlo_u, r.dli_v)
    bl_neg = (~bitset.subset(r.blin_u, r.blin_v)
              | ~bitset.subset(r.blout_v, r.blout_u))
    thm = (bitset.intersect_any(r.dlo_v, r.dli_u)
           | bitset.intersect_any(r.dlo_u, r.dli_u)
           | bitset.intersect_any(r.dlo_v, r.dli_v))
    return pos_lbl, bl_neg, thm


def _verdict(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(pos, dtype=torch.int8)
    return torch.where(pos, one, torch.where(neg, one * 0, -one))


def label_verdicts(p: PackedLabels, u: torch.Tensor, v: torch.Tensor,
                   il=None) -> torch.Tensor:
    """(Q,) int8 verdicts from labels only (Alg 2 lines 6-13): the cutoff
    verdicts with every lane fresh."""
    return cut_verdicts(p, u, v, 1, 0, True, il=il)


def dirty_label_verdicts(p: PackedLabels, u: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """(Q,) int8 verdicts sound for a dirty index (pending deletions):
    self-queries stay +1, BL containment violations stay 0, everything
    else is unknown and rides the live-edge BFS."""
    _, bl_neg, _ = verdict_parts_rows(gather_rows(p, u, v))
    return _verdict(u == v, bl_neg)


def asof_verdicts(verd: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  m_cut, m_total) -> torch.Tensor:
    """Downgrade verdicts computed from newer labels to be valid as of a
    per-lane edge-count cutoff: 0 stays 0 (unreachable under a superset
    stays unreachable), +1 survives only on fresh lanes
    (``m_cut >= m_total``) or self-queries, else it becomes -1."""
    stale_pos = (verd == 1) & ~(m_cut >= m_total) & (u != v)
    return torch.where(stale_pos, torch.full_like(verd, -1),
                       verd).to(torch.int8)


def label_stats(p: PackedLabels, u: torch.Tensor, v: torch.Tensor) -> dict:
    """Per-mechanism answer masks (paper Table 4 columns)."""
    r = gather_rows(p, u, v)
    pos = bitset.intersect_any(r.dlo_u, r.dli_v) | (u == v)
    thm1 = ~pos & bitset.intersect_any(r.dlo_v, r.dli_u)
    thm2 = ~pos & (bitset.intersect_any(r.dlo_u, r.dli_u)
                   | bitset.intersect_any(r.dlo_v, r.dli_v))
    bl_neg = (~bitset.subset(r.blin_u, r.blin_v)
              | ~bitset.subset(r.blout_v, r.blout_u))
    dl_only = pos | thm1 | thm2
    return {"dl": dl_only, "bl": ~pos & bl_neg,
            "dbl": dl_only | (~pos & bl_neg)}


def cut_verdicts(p: PackedLabels, u, v, m_cut, m_total, d_fresh,
                 il=None) -> torch.Tensor:
    """(Q,) int8 verdicts with both staleness cutoffs: label positives on
    lanes with ``m_cut < m_total`` degrade to unknown, and when ``d_fresh``
    is False (labels carry un-rebuilt deletions) only self-queries and BL
    negatives survive."""
    return cut_verdicts_rows(gather_rows(p, u, v), u, v, m_cut, m_total,
                             d_fresh, il_rows=gather_il_rows(il, u, v))


def cut_verdicts_rows(r: RowBlocks, u, v, m_cut, m_total, d_fresh,
                      il_rows=None) -> torch.Tensor:
    """``cut_verdicts`` from gathered rows.  ``m_cut``/``m_total``/
    ``d_fresh`` are tensors or Python scalars and broadcast over (Q,)."""
    pos_lbl, bl_neg, thm = verdict_parts_rows(r)
    same = u == v
    m_fresh = m_cut >= m_total      # a tensor, or a bool for scalars
    pos0 = pos_lbl | same
    neg_lbl = bl_neg if il_rows is None else bl_neg | il_negative(*il_rows)
    neg0 = ~pos0 & (neg_lbl | thm)
    pos = (pos_lbl & m_fresh & d_fresh) | same
    if isinstance(d_fresh, torch.Tensor):
        neg = torch.where(d_fresh, neg0, ~same & bl_neg)
    else:
        neg = neg0 if d_fresh else ~same & bl_neg
    return _verdict(pos, neg)


def verdict_counts(verd: torch.Tensor, r: RowBlocks,
                   il_rows=None) -> torch.Tensor:
    """(4,) int32 per-family attribution [dl+, bl-, il-, thm-] of one
    verdict batch: positives to DL, negatives to BL containment first,
    then interval containment, then the theorem rules."""
    _, bl_neg, _ = verdict_parts_rows(r)
    il_neg = torch.zeros_like(bl_neg) if il_rows is None \
        else il_negative(*il_rows)
    neg = verd == 0
    return torch.stack([
        (verd == 1).sum(), (neg & bl_neg).sum(),
        (neg & ~bl_neg & il_neg).sum(), (neg & ~bl_neg & ~il_neg).sum(),
    ]).to(torch.int32)


def il_violation_plane(il, v: torch.Tensor) -> torch.Tensor:
    """(n_cap, Q) bool: vertex x violates interval containment against v_q."""
    il_in, il_out = il
    return ((il_out[:, None, :] > rows(il_out, v)[None, :, :]).any(-1)
            | (rows(il_in, v)[None, :, :] > il_in[:, None, :]).any(-1))


def admit_rows(bl_in: torch.Tensor, bl_out: torch.Tensor,
               dl_in: torch.Tensor, dlo_u: torch.Tensor, blin_v: torch.Tensor,
               blout_v: torch.Tensor, dl_on: torch.Tensor | None = None
               ) -> torch.Tensor:
    """(rows, Qc) bool admit block of the plane rows ``bl_in``/``bl_out``/
    ``dl_in`` (rows, W) against the query rows ``dlo_u`` = DL_out(u_q),
    ``blin_v`` = BL_in(v_q), ``blout_v`` = BL_out(v_q) (Qc, W):

    admit = BL_in(x) ⊆ BL_in(v_q) ∧ BL_out(v_q) ⊆ BL_out(x)
            ∧ ¬(DL_out(u_q) ∩ DL_in(x) ≠ ∅)
    ``dl_on`` (Qc,) gates the DL term per lane (off for epoch-stale or
    deletion-stale lanes).  Row-parallel: a shard passes its own rows."""
    c1 = bitset.subset(bl_in[:, None, :], blin_v[None, :, :])
    c2 = bitset.subset(blout_v[None, :, :], bl_out[:, None, :])
    d = bitset.intersect_any(dlo_u[None, :, :], dl_in[:, None, :])
    if dl_on is not None:
        d = d & dl_on[None, :]
    return c1 & c2 & ~d


def _admit_plane(p: PackedLabels, u: torch.Tensor, v: torch.Tensor,
                 n_cap: int, dl_on: torch.Tensor | None = None,
                 il=None, il_on: torch.Tensor | None = None) -> torch.Tensor:
    """(n_cap, Qc) bool: vertices x admissible in query q's BFS
    (:func:`admit_rows` over every row).  ``il`` = (il_in, il_out) adds
    ¬IL_Violate(x, v_q); ``il_on`` (0-d or (Qc,) bool) gates it: the
    prune is not deletion-sound, so a dirty dispatch turns it off."""
    admit = admit_rows(p.bl_in, p.bl_out, p.dl_in, rows(p.dl_out, u),
                       rows(p.bl_in, v), rows(p.bl_out, v), dl_on)
    if il is not None:
        bad = il_violation_plane(il, v)
        if il_on is not None:
            bad = bad & il_on
        admit = admit & ~bad
    return admit


def relax_edges(tails: torch.Tensor, heads: torch.Tensor,
                live: torch.Tensor, n_cap: int):
    """(tails, heads, live) ready for :func:`relax`: tails clamped into
    ``[0, n_cap)`` as the reference's gathers clamp, heads as int64, and
    edges whose head lies outside ``[0, n_cap)`` dropped from ``live``, as
    the reference's segment reductions drop them."""
    live = live & (heads >= 0) & (heads < n_cap)
    return tails.clamp(0, n_cap - 1).long(), heads.long(), live


def relax(frontier: torch.Tensor, tails: torch.Tensor, heads: torch.Tensor,
          live: torch.Tensor, *, n_cap: int, ftype=torch.int8,
          m_cut: torch.Tensor | None = None) -> torch.Tensor:
    """(n_cap, Q) bool: one BFS level of Q lanes.  Row x is set on lane q
    when a ``live`` edge ``tails[e] -> heads[e] = x`` has its tail on lane
    q's ``frontier`` (n_cap, Q) bool and, with ``m_cut`` (Q,), an edge
    index ``e < m_cut[q]``.  Through the op ``repro_torch::bfs_relax``:
    one step of its kernel for CUDA operands, with no host read; for CPU
    operands its plain version, which gathers the frontier's edges
    (``nonzero``, a host read) and OR-s their lane rows into their heads
    by ``index_reduce_("amax")`` on ``ftype``.  The relax step of
    :func:`pruned_bfs` and of the B-BFS baseline; edges as
    :func:`relax_edges` gives them (a backward step passes the edges'
    heads as ``tails``)."""
    # imported here: the kernels' modules import this one
    from repro_torch.kernels.bfs_relax.bfs_relax import bfs_relax
    return bfs_relax(frontier, tails, heads, live, m_cut, n_cap, ftype)


def bfs_prologue(g: Graph, p: PackedLabels | None, u: torch.Tensor,
                 v: torch.Tensor, admit: torch.Tensor | None = None,
                 m_cut: torch.Tensor | None = None,
                 dl_clean: bool | torch.Tensor | None = None, il=None, *,
                 n_cap: int, frontier_dtype: str = "int8"):
    """Everything :func:`pruned_bfs` does before its first round, as
    ``(carry, consts, go)``: the loop-carried tensors (frontier, visited,
    hit; words on the packed path), the loop-invariant ones (the admit
    plane, the edges as :func:`relax_edges` gives them, the lanes' cutoffs
    and targets) and the 0-d bool that the host reads to decide on the
    first round.  Tensors only, with ``g.m`` and ``g.del_epoch`` read as
    ints or 0-d tensors, and no host read, so that ``torch.export`` can
    take it whole.  ``dl_clean`` (a bool or a 0-d bool tensor, as the
    engine's phases pass it) gates the DL prune and the interval prune
    with tensor ops, never read on the host.  ``consts[1]`` is the
    (m_cap,) edge tails and ``consts[4]`` ``m_cut`` on both paths."""
    dev = u.device
    qc = u.shape[0]
    live = edge_mask(g)
    if admit is None:
        clean = dl_clean
        if clean is not None and not isinstance(clean, torch.Tensor):
            clean = torch.full((), bool(clean), dtype=torch.bool, device=dev)
        if m_cut is None:
            dl_on = None if clean is None else clean.expand(qc)
        else:
            dl_on = m_cut >= g.m
            if clean is not None:
                dl_on = dl_on & clean
        admit = _admit_plane(p, u, v, n_cap, dl_on, il, clean)
    elif admit.dtype != torch.bool:
        admit = admit > 0
    ids = torch.arange(n_cap, device=dev)
    frontier = ids[:, None] == u[None, :].long()        # (n_cap, Qc)
    lanes = torch.arange(qc, device=dev)
    v_safe = v.clamp(0, n_cap - 1).long()
    src, dst, live = relax_edges(g.src, g.dst, live, n_cap)
    if frontier_dtype == "packed":
        lane_mask = bitset.pad_mask(qc, dev)
        fw = bitset.pack(frontier)
        hw = torch.zeros_like(lane_mask)
        consts = (bitset.pack(admit), src, dst, live, m_cut, v_safe,
                  lanes // bitset.WORD, lanes % bitset.WORD, lane_mask)
        return (fw, fw, hw), consts, _packed_go(fw, hw, lane_mask)
    hit = torch.zeros(qc, dtype=torch.bool, device=dev)
    consts = (admit, src, dst, live, m_cut, v_safe, lanes)
    return (frontier, frontier.clone(), hit), consts, \
        frontier.any() & ~hit.all()


def _packed_go(fw: torch.Tensor, hw: torch.Tensor, lane_mask: torch.Tensor
               ) -> torch.Tensor:
    return (fw != 0).any() & ((hw & lane_mask) != lane_mask).any()


def bfs_round(carry, consts, *, frontier_dtype: str = "int8"):
    """One round of the lane-wise loop on :func:`bfs_prologue`'s state:
    ``(carry, go)``.  Relax the frontier along the live (and, per lane,
    cut-admitted) edges (:func:`relax`), gate by admit, visited and hit,
    and gather the targets' rows.  The packed path keeps frontier,
    visited and hit in words and relaxes through the frontier's (n_cap,
    Qc) bytes: one relax step, as the int8 path, where an OR of words by
    head would take a scan of ``log2`` of the longest in-edge run (a host
    read, or ``log2(m_cap)`` steps where there is none); the words are
    the same."""
    if frontier_dtype == "packed":
        fw, vw, hw = carry
        admit_w, src, dst, live, m_cut, v_safe, lw, lb, lane_mask = consts
        nxt = relax(bitset.unpack(fw, v_safe.shape[0]), src, dst, live,
                    n_cap=admit_w.shape[0], m_cut=m_cut)
        nw = bitset.pack(nxt) & admit_w & ~vw & ~hw[None, :]
        hits = ((nw[v_safe, lw] >> lb) & 1) != 0
        hw = hw | bitset.pack(hits)
        return (nw, vw | nw, hw), _packed_go(nw, hw, lane_mask)
    frontier, visited, hit = carry
    admit, src, dst, live, m_cut, v_safe, lanes = consts
    nxt = relax(frontier, src, dst, live, n_cap=admit.shape[0],
                ftype=FRONTIER_DTYPES[frontier_dtype], m_cut=m_cut)
    nxt = nxt & admit & ~visited & ~hit[None, :]
    hit = hit | nxt[v_safe, lanes]
    return (nxt, visited | nxt, hit), nxt.any() & ~hit.all()


def bfs_hits(carry, qc: int, frontier_dtype: str = "int8") -> torch.Tensor:
    """(Qc,) bool hits of a BFS state."""
    if frontier_dtype == "packed":
        return bitset.unpack(carry[2], qc)
    return carry[2]


def pruned_bfs(g: Graph, p: PackedLabels | None, u: torch.Tensor,
               v: torch.Tensor,
               admit: torch.Tensor | None = None,
               m_cut: torch.Tensor | None = None,
               dl_clean: bool | torch.Tensor | None = None, il=None, *,
               n_cap: int, max_iters: int = 256, frontier_dtype: str = "int8"
               ) -> torch.Tensor:
    """(Qc,) bool: resolve unknown queries by label-pruned BFS lanes.

    ``admit`` is a precomputed (n_cap, Qc) admit plane of any dtype (the
    bfs_prune kernel's int8 plane), else the torch plane is built here
    from ``p``, which is read for nothing else (a caller with a plane of
    its own, as the IP-lite baseline has, may pass ``p=None``).
    ``m_cut`` (Qc,) int32 is a per-lane edge-count cutoff: lane q traverses
    only edges with append index < m_cut[q], i.e. the edge set of its
    snapshot.  Stale lanes (m_cut < g.m) drop the DL prune.  ``dl_clean``
    False (labels carry un-rebuilt deletions) drops it for every lane.
    ``il`` (il_in, il_out) adds the interval prune to the admit plane; it
    needs no edge-count gate but shares the ``dl_clean`` gate (it is not
    deletion-sound, so a dirty dispatch drops it).

    :func:`bfs_prologue`, then :func:`bfs_round` while the host's read of
    the round's ``go`` (some frontier left, some lane unhit) says so, at
    most ``max_iters`` times; only edges whose source row is on the
    frontier take part.  ``frontier_dtype`` "packed" runs the loop on
    int32 words of 32 query lanes: the same rounds and hits.
    """
    carry, consts, go = bfs_prologue(g, p, u, v, admit, m_cut, dl_clean, il,
                                     n_cap=n_cap,
                                     frontier_dtype=frontier_dtype)
    it = 0
    while it < max_iters and bool(go):
        carry, go = bfs_round(carry, consts, frontier_dtype=frontier_dtype)
        it += 1
    return bfs_hits(carry, u.shape[0], frontier_dtype)


def query(g: Graph, p: PackedLabels, u, v, *, n_cap: int,
          bfs_chunk: int = 64, max_iters: int = 256,
          return_stats: bool = False, dirty: bool = False, il=None):
    """Full Alg 2 over a query batch: the host-side reference driver.

    Verdicts go to the host, unknowns are sliced with numpy and resolved
    one padded BFS chunk at a time.  Kept as the differential oracle for
    ``repro_torch.serve.engine.QueryEngine``.  ``dirty=True`` keeps only
    self-positives and BL negatives from labels and drops the DL prune.
    ``il`` threads the interval planes through both phases; the dirty path
    drops them."""
    dev = p.dl_in.device
    u_np = np.asarray(u, np.int32).ravel()
    v_np = np.asarray(v, np.int32).ravel()
    uu_all = torch.from_numpy(u_np).to(dev)
    vv_all = torch.from_numpy(v_np).to(dev)
    if dirty:
        verdicts = cut_verdicts(p, uu_all, vv_all, 1, 0, False)
        il = None
    else:
        verdicts = label_verdicts(p, uu_all, vv_all, il=il)
    verdicts = verdicts.cpu().numpy()
    answers = verdicts == 1
    unknown = np.flatnonzero(verdicts == -1)
    dl_clean = None if not dirty else False
    for lo in range(0, unknown.size, bfs_chunk):
        idx = unknown[lo:lo + bfs_chunk]
        pad = bfs_chunk - idx.size
        uu = torch.from_numpy(np.pad(u_np[idx], (0, pad))).to(dev)
        vv = torch.from_numpy(np.pad(v_np[idx], (0, pad))).to(dev)
        hit = pruned_bfs(g, p, uu, vv, dl_clean=dl_clean, il=il,
                         n_cap=n_cap, max_iters=max_iters).cpu().numpy()
        answers[idx] = hit[:idx.size]
    if return_stats:
        rho = 1.0 - unknown.size / max(1, verdicts.size)
        return answers, {"rho": rho, "n_bfs": int(unknown.size)}
    return answers
