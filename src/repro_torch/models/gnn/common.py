"""Shared GNN utilities on tensors: masked segment aggregation, input
embeddings, edge geometry, triplet construction (DimeNet), Legendre
polynomials and the MLP block.  The bridge that carries a parameter tree of
numpy arrays into a module and its gradients back out lives in
``repro_torch.models.params`` and is re-exported here.

A batch is a dict of tensors on one device: ``edge_index`` (2, m) int,
``edge_valid`` (m,) bool, ``node_feat`` (n, d_feat) float or None,
``species`` (n,) int, and per model ``positions``, ``labels``,
``graph_ids``/``n_graphs``, ``energy_target`` and the triplet lists.
Edge lengths are ``sqrt(sum(vec * vec))``, as ``jnp.linalg.norm`` computes
them, so a zero-length edge (a self-loop) gives a NaN gradient into the
positions exactly where the reference does; ``torch.linalg.norm`` would
give 0 there.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.graphs.segment import segment_reduce
from repro_torch.models.params import (  # noqa: F401  (re-exported)
    flatten_tree, grads_to_numpy, load_numpy_params, sgd_step)


def masked_dst(edge_index, edge_valid, n):
    """Route invalid edges to a dump segment n, which the reductions drop."""
    return torch.where(edge_valid, edge_index[1], n)


def masked_max_min(msg, valid, d, cnt, n):
    """Segment max and min over valid edges; empty segments -> 0."""
    big = torch.finfo(msg.dtype).max
    mmax = segment_reduce(torch.where(valid[:, None], msg, -big), d, n,
                          "amax")
    mmin = segment_reduce(torch.where(valid[:, None], msg, big), d, n,
                          "amin")
    return (torch.where(cnt > 0, mmax, 0.0), torch.where(cnt > 0, mmin, 0.0))


def multi_aggregate(msg, edge_index, edge_valid, n):
    """(mean, max, min, std, count) over valid in-edges; empty segments ->
    0.  The count and the mean and std divisions are float32 whatever
    ``msg``'s type, the sums and extremes in ``msg``'s type."""
    d = masked_dst(edge_index, edge_valid, n)
    ones = edge_valid.to(torch.float32)
    cnt = segment_reduce(ones, d, n)
    safe = torch.clamp(cnt, min=1.0)[:, None]
    msg_m = msg * ones.to(msg.dtype)[:, None]
    mean = segment_reduce(msg_m, d, n) / safe
    s2 = segment_reduce(msg_m * msg_m, d, n)
    std = torch.sqrt(torch.clamp(s2 / safe - mean * mean, min=0.0) + 1e-5)
    mmax, mmin = masked_max_min(msg, edge_valid, d, cnt[:, None], n)
    return mean, mmax, mmin, std, cnt


def scatter_sum_valid(msg, edge_index, edge_valid, n):
    d = masked_dst(edge_index, edge_valid, n)
    return segment_reduce(msg * edge_valid[:, None].to(msg.dtype), d, n)


def input_embed(model, batch):
    """node_feat projection if present, else species embedding."""
    if batch.get("node_feat") is not None:
        return batch["node_feat"] @ model.w_in
    return model.species_embed[batch["species"].long()]


def edge_vectors(batch):
    """(m, 3) displacement src -> dst and (m,) length; the length's
    gradient is NaN at 0, as the reference's ``jnp.linalg.norm``'s is."""
    pos = batch["positions"]
    ei = batch["edge_index"].long()
    vec = pos[ei[1]] - pos[ei[0]]
    return vec, torch.sqrt((vec * vec).sum(-1))


def build_triplets(edge_index: np.ndarray, edge_valid: np.ndarray,
                   max_triplets: int):
    """Host-side (k->j) , (j->i) triplet index build for DimeNet.

    Returns (t_in, t_out, valid): for each triplet, t_in is the edge id of
    (k->j), t_out the edge id of (j->i), with k != i.
    """
    src, dst = edge_index[0], edge_index[1]
    m = src.shape[0]
    by_dst: dict[int, list[int]] = {}
    for e in range(m):
        if edge_valid[e]:
            by_dst.setdefault(int(dst[e]), []).append(e)
    t_in, t_out = [], []
    for e_out in range(m):
        if not edge_valid[e_out]:
            continue
        j = int(src[e_out])
        i = int(dst[e_out])
        for e_in in by_dst.get(j, ()):  # k -> j
            if int(src[e_in]) == i:
                continue
            t_in.append(e_in)
            t_out.append(e_out)
            if len(t_in) >= max_triplets:
                break
        if len(t_in) >= max_triplets:
            break
    cnt = len(t_in)
    pad = max_triplets - cnt
    t_in = np.asarray(t_in + [0] * pad, np.int32)
    t_out = np.asarray(t_out + [0] * pad, np.int32)
    valid = np.asarray([True] * cnt + [False] * pad)
    return t_in, t_out, valid


def legendre(cos_t: torch.Tensor, n: int) -> torch.Tensor:
    """P_0..P_{n-1}(cos_t) via recurrence -> (..., n)."""
    outs = [torch.ones_like(cos_t)]
    if n > 1:
        outs.append(cos_t)
    for l in range(2, n):
        outs.append(((2 * l - 1) * cos_t * outs[-1]
                     - (l - 1) * outs[-2]) / l)
    return torch.stack(outs, dim=-1)


def normal(gen: torch.Generator, shape, scale: float) -> nn.Parameter:
    """A float32 parameter drawn from N(0, scale^2) on ``gen``."""
    return nn.Parameter(torch.randn(shape, generator=gen) * scale)


def per_l(l_max: int, make) -> nn.ParameterDict:
    """One parameter per irrep order l = 0..l_max, keyed ``str(l)``: the
    reference keys these dicts by the integer l, and ``flatten_tree``
    names an integer key by its string."""
    return nn.ParameterDict({str(l): make(l) for l in range(l_max + 1)})


class MLP(nn.Module):
    """The reference's ``mlp_init``/``mlp_apply``: parameters ``w{i}`` (in,
    out) and ``b{i}``, ``x @ w + b``, SiLU between layers (and after the
    last with ``final_act``)."""

    def __init__(self, sizes, gen: torch.Generator, scale=None):
        super().__init__()
        self.n = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            s = scale if scale is not None else a ** -0.5
            self.register_parameter(f"w{i}", normal(gen, (a, b), s))
            self.register_parameter(f"b{i}",
                                    nn.Parameter(torch.zeros(b)))

    def forward(self, x, final_act=False):
        for i in range(self.n):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n - 1 or final_act:
                x = F.silu(x)
        return x


def cross_entropy(logits, labels, mask=None):
    """Mean of ``logsumexp(logits) - logits[label]`` (over ``mask`` when
    given), as the reference's node-classification losses take it."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    ce = lse - gold
    if mask is not None:
        ce = torch.where(mask, ce, 0.0)
        return ce.sum() / torch.clamp(mask.sum(), min=1)
    return ce.mean()


def energy_forces(model, batch):
    """(energy (B,), forces (n, 3) = -dE/dpositions)."""
    pos = batch["positions"].detach().requires_grad_(True)
    e = model.energy({**batch, "positions": pos})
    (grad,) = torch.autograd.grad(e.sum(), pos)
    return e.detach(), -grad


class Potential(nn.Module):
    """What NequIP, MACE and DimeNet share around their ``forward`` (batch
    -> per-atom embedding (n, d)): per-graph energy through the head named
    by ``readout``, forces, node logits through ``node_head``, and the
    loss (energy MSE when the batch has ``energy_target``, else node
    cross-entropy)."""

    readout = "head"

    def apply(self, batch):
        """The reference's name for ``forward`` (shadows
        ``nn.Module.apply``)."""
        return self(batch)

    def energy(self, batch) -> torch.Tensor:
        """Per-graph energies (B,) via graph_ids (the total as (1,) without
        them)."""
        e_atom = getattr(self, self.readout)(self(batch))[:, 0]
        gid = batch.get("graph_ids")
        if gid is None:
            return e_atom.sum()[None]
        return segment_reduce(e_atom, gid, batch["n_graphs"])

    def forces(self, batch) -> torch.Tensor:
        return energy_forces(self, batch)[1]

    def node_logits(self, batch) -> torch.Tensor:
        return self(batch) @ self.node_head

    def loss_fn(self, batch):
        if "energy_target" in batch:
            e = self.energy(batch)
            return torch.mean((e - batch["energy_target"]) ** 2), {}
        return cross_entropy(self.node_logits(batch), batch["labels"]), {}
