"""Layered neighbor sampling (GraphSAGE-style) for minibatch GNN training.

Host-side numpy: CSR sampling into fixed-shape (padded) subgraphs, the
fanout 15-10 sampling of the ``minibatch_lg`` shape over a Reddit-scale
graph.  Also the DBL-composed variant, reachability-filtered sampling:
a sampled edge is kept only if the dynamic DBL index certifies that its
source reaches a target.  The index is duck-typed (anything with
``query(u, v)`` returning a bool array: ``DBLIndex``, ``QueryEngine``,
``ReachabilityServer``), and its queries run on its own device.  The
random draws come in the reference's order, so one seed gives the same
subgraph bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class CSR(NamedTuple):
    indptr: np.ndarray   # (n+1,)
    indices: np.ndarray  # (m,) — in-neighbors (sources) per destination

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray) -> "CSR":
        order = np.argsort(dst, kind="stable")
        s, d = src[order], dst[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, d + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, s.astype(np.int32))


class SampledBlock(NamedTuple):
    """One message-passing layer: edges from sampled srcs -> seed dsts."""
    src: np.ndarray        # (E_pad,) int32 — indices INTO the node list
    dst: np.ndarray        # (E_pad,) int32
    edge_valid: np.ndarray  # (E_pad,) bool


class SampledSubgraph(NamedTuple):
    nodes: np.ndarray              # (N_pad,) int32 global node ids
    node_valid: np.ndarray         # (N_pad,) bool
    blocks: tuple                  # outermost-first SampledBlock per layer
    seed_count: int                # first seed_count nodes are the batch


def sample_neighbors(csr: CSR, batch_nodes: np.ndarray,
                     fanouts: Sequence[int], *, rng: np.random.Generator,
                     pad_to_fanout: bool = True) -> SampledSubgraph:
    """Uniform fanout sampling.  Shapes are deterministic in
    (len(batch), fanouts): layer l has exactly len(prev)*fanout[l] edge slots,
    invalid slots masked (vertices with degree < fanout sample w/o enough
    neighbors are padded, matching fixed-shape device buffers)."""
    node_list = [batch_nodes.astype(np.int32)]
    id_of = {int(v): i for i, v in enumerate(batch_nodes)}
    blocks = []
    frontier = batch_nodes.astype(np.int64)
    for fan in fanouts:
        e_src, e_dst, e_val = [], [], []
        new_frontier = []
        for local_dst, v in enumerate(frontier):
            dst_slot = id_of[int(v)] if int(v) in id_of else None
            lo, hi = csr.indptr[v], csr.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                picks = np.full(fan, -1, np.int64)
            else:
                picks = csr.indices[lo + rng.integers(0, deg, size=fan)]
            for p in picks:
                if p < 0:
                    e_src.append(0)
                    e_dst.append(dst_slot)
                    e_val.append(False)
                    continue
                p = int(p)
                if p not in id_of:
                    id_of[p] = len(id_of)
                    node_list.append(np.asarray([p], np.int32))
                    new_frontier.append(p)
                e_src.append(id_of[p])
                e_dst.append(dst_slot)
                e_val.append(True)
        blocks.append(SampledBlock(np.asarray(e_src, np.int32),
                                   np.asarray(e_dst, np.int32),
                                   np.asarray(e_val, bool)))
        frontier = np.asarray(new_frontier, np.int64)
        if frontier.size == 0:
            frontier = np.asarray([int(batch_nodes[0])], np.int64)
    nodes = np.concatenate(node_list)
    return SampledSubgraph(nodes, np.ones(nodes.shape, bool),
                           tuple(blocks), len(batch_nodes))


def reachability_filtered_sample(csr: CSR, batch_nodes: np.ndarray,
                                 fanouts: Sequence[int], dbl_index,
                                 targets: np.ndarray, *,
                                 rng: np.random.Generator) -> SampledSubgraph:
    """DBL-composed sampler: after uniform sampling, invalidate edges whose
    source cannot reach any target (certified by the dynamic DBL index).
    Used when training on evolving graphs where only flow-relevant
    neighborhoods matter."""
    sub = sample_neighbors(csr, batch_nodes, fanouts, rng=rng)
    tgt = np.asarray(targets, np.int32)
    uniq = np.unique(sub.nodes)
    # batched query: node u kept if it reaches ANY target
    keep = np.zeros(uniq.size, bool)
    for t in tgt:
        ans = dbl_index.query(uniq.astype(np.int32),
                              np.full(uniq.size, t, np.int32))
        keep |= np.asarray(ans)
    keep_set = set(uniq[keep].tolist())
    blocks = []
    for blk in sub.blocks:
        valid = blk.edge_valid.copy()
        src_global = sub.nodes[blk.src]
        for i in range(valid.size):
            if valid[i] and int(src_global[i]) not in keep_set:
                valid[i] = False
        blocks.append(SampledBlock(blk.src, blk.dst, valid))
    return SampledSubgraph(sub.nodes, sub.node_valid, tuple(blocks),
                           sub.seed_count)
