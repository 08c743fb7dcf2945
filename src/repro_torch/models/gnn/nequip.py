"""NequIP — E(3)-equivariant interatomic potential [arXiv:2101.03164].

Features are irrep dicts {l: (n, C, 2l+1)} for l <= l_max.  Each interaction
layer: radial-MLP-weighted Clebsch-Gordan tensor-product convolution over
edges (spherical-harmonic edge attributes), scatter-sum aggregation,
per-l self-interaction linears, and gate nonlinearity (l=0 silu; l>0 gated
by sigmoid scalars).  Energy = sum of per-atom scalar head; forces =
-∂E/∂positions.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import GNNConfig
from .common import (MLP, Potential, edge_vectors, normal, per_l,
                     scatter_sum_valid)
from .irreps import bessel_basis, clebsch_gordan, spherical_harmonics


def paths(l_max: int):
    out = []
    for li in range(l_max + 1):
        for lf in range(l_max + 1):
            for lo in range(abs(li - lf), min(l_max, li + lf) + 1):
                out.append((li, lf, lo))
    return out


def register_cg(module: nn.Module, triples):
    """The real CG tensors of ``triples`` as float32 buffers ``cg_l1_l2_lo``
    (not parameters: they move with ``.to`` and are never trained)."""
    for l1, l2, lo in triples:
        module.register_buffer(
            f"cg_{l1}_{l2}_{lo}",
            torch.as_tensor(clebsch_gordan(l1, l2, lo), dtype=torch.float32),
            persistent=False)


def cg(module: nn.Module, l1: int, l2: int, lo: int) -> torch.Tensor:
    return getattr(module, f"cg_{l1}_{l2}_{lo}")


def tp_convolution(module, cfg, radial, feat, ei, valid, sh, rbf, n):
    """One radial-weighted CG tensor-product convolution over the edges
    (NequIP's interaction, MACE's A-basis); returns dict l -> (n, C, 2l+1)."""
    c = cfg.d_hidden
    ps = paths(cfg.l_max)
    w_all = radial(rbf).reshape(rbf.shape[0], len(ps), c)
    src = ei[0]
    out = {l: torch.zeros((n, c, 2 * l + 1), dtype=feat[0].dtype,
                          device=feat[0].device)
           for l in range(cfg.l_max + 1)}
    for pi, (li, lf, lo) in enumerate(ps):
        msg = torch.einsum("eci,ej,ijk->eck", feat[li][src], sh[lf],
                           cg(module, li, lf, lo))
        msg = msg * w_all[:, pi, :, None]
        agg = scatter_sum_valid(msg.reshape(msg.shape[0], -1), ei, valid, n)
        out[lo] = out[lo] + agg.reshape(n, c, 2 * lo + 1)
    return out


def embed_geometry(model, cfg, batch):
    """(edge_index long, sh, rbf, initial irrep features, edge norm) for
    NequIP and MACE."""
    ei = batch["edge_index"].long()
    valid = batch["edge_valid"]
    n = batch["positions"].shape[0]
    vec, r = edge_vectors(batch)
    sh = spherical_harmonics(vec, cfg.l_max)
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)
    f0 = model.species_embed[batch["species"].long()]
    if batch.get("node_feat") is not None and model.w_in is not None:
        f0 = f0 + batch["node_feat"] @ model.w_in
    feat = {0: f0[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        feat[l] = f0.new_zeros((n, cfg.d_hidden, 2 * l + 1))
    norm = 1.0 / torch.sqrt(torch.clamp(valid.sum() / n, min=1.0))
    return ei, sh, rbf, feat, norm


def init_common(model, cfg: GNNConfig, d_feat: int, gen: torch.Generator):
    """NequIP's and MACE's embeddings and heads, on ``model``."""
    c = cfg.d_hidden
    model.cfg = cfg
    model.species_embed = normal(gen, (cfg.n_species, c), 0.3)
    model.w_in = normal(gen, (d_feat, c), d_feat ** -0.5) if d_feat else None
    model.head = MLP((c, c, 1), gen)
    model.node_head = normal(gen, (c, cfg.n_classes), c ** -0.5)


class NequIPLayer(nn.Module):
    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        c = cfg.d_hidden
        self.radial = MLP((cfg.n_rbf, 64, len(paths(cfg.l_max)) * c), gen)
        self.self = per_l(cfg.l_max, lambda l: normal(gen, (c, c), c ** -0.5))
        self.skip = per_l(cfg.l_max, lambda l: normal(gen, (c, c), c ** -0.5))
        self.gate = normal(gen, (c, cfg.l_max * c), c ** -0.5)


class NequIP(Potential):
    def __init__(self, cfg: GNNConfig, d_feat: int, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        init_common(self, cfg, d_feat, gen)
        self.layers = nn.ModuleList(NequIPLayer(cfg, gen)
                                    for _ in range(cfg.n_layers))
        register_cg(self, paths(cfg.l_max))

    def forward(self, batch) -> torch.Tensor:
        cfg = self.cfg
        c = cfg.d_hidden
        ei, sh, rbf, feat, norm = embed_geometry(self, cfg, batch)
        valid = batch["edge_valid"]
        n = feat[0].shape[0]
        for lp in self.layers:
            m = tp_convolution(self, cfg, lp.radial, feat, ei, valid, sh,
                               rbf, n)
            new = {}
            for l in range(cfg.l_max + 1):
                lin = torch.einsum("nci,cd->ndi", m[l] * norm,
                                   lp.self[str(l)])
                skip = torch.einsum("nci,cd->ndi", feat[l], lp.skip[str(l)])
                new[l] = lin + skip
            gates = torch.sigmoid(new[0][:, :, 0] @ lp.gate
                                  ).reshape(n, cfg.l_max, c)
            feat = {0: F.silu(new[0][:, :, 0])[:, :, None]}
            for l in range(1, cfg.l_max + 1):
                feat[l] = new[l] * gates[:, l - 1, :, None]
        return feat[0][:, :, 0]
