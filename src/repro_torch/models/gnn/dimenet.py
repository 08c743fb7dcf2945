"""DimeNet — directional message passing [arXiv:2003.03123].

Messages live on *edges*; interaction blocks couple message m_kj into m_ji
through a spherical basis (radial Bessel x Legendre of the angle k-j-i) and
a bilinear layer — the triplet-gather regime that plain SpMM cannot
express.  Triplet index lists are built host-side (common.build_triplets)
and padded; all device work is fixed-shape gathers + segment reductions.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.graphs.segment import segment_reduce
from .common import MLP, Potential, edge_vectors, legendre, normal
from .irreps import bessel_basis


class DimeNetBlock(nn.Module):
    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.d_hidden
        n_sbf = cfg.n_spherical * cfg.n_radial
        self.w_self = normal(gen, (d, d), d ** -0.5)
        self.w_msg = normal(gen, (d, d), d ** -0.5)
        self.w_sbf = normal(gen, (n_sbf, cfg.n_bilinear), n_sbf ** -0.5)
        self.w_bilinear = normal(gen, (cfg.n_bilinear, d, d),
                                 (cfg.n_bilinear * d) ** -0.5)
        self.mlp = MLP((d, d, d), gen)
        self.out = MLP((d, d), gen)
        if cfg.trip_proj_dim:
            self.w_proj_up = normal(gen, (cfg.trip_proj_dim, d),
                                    cfg.trip_proj_dim ** -0.5)


class DimeNet(Potential):
    readout = "out_head"

    def __init__(self, cfg: GNNConfig, d_feat: int, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_hidden
        self.cfg = cfg
        self.species_embed = normal(gen, (cfg.n_species, d), 0.3)
        self.w_in = normal(gen, (d_feat, d), d_feat ** -0.5) \
            if d_feat else None
        self.rbf_lin = normal(gen, (cfg.n_radial, d), cfg.n_radial ** -0.5)
        self.edge_mlp = MLP((3 * d, d, d), gen)
        self.blocks = nn.ModuleList(DimeNetBlock(cfg, gen)
                                    for _ in range(cfg.n_blocks))
        self.out_head = MLP((d, d, 1), gen)
        self.node_head = normal(gen, (d, cfg.n_classes), d ** -0.5)

    def _sbf(self, r_in, cos_angle):
        """Spherical basis for triplets: radial(r_kj) ⊗ Legendre(cos α) ->
        (T, n_spherical * n_radial)."""
        cfg = self.cfg
        rad = bessel_basis(r_in, cfg.n_radial, cfg.cutoff)   # (T, n_radial)
        ang = legendre(cos_angle, cfg.n_spherical)            # (T, n_sph)
        return (rad[:, None, :] * ang[:, :, None]).reshape(
            r_in.shape[0], cfg.n_spherical * cfg.n_radial)

    def forward(self, batch) -> torch.Tensor:
        """-> node embeddings (n, d_hidden) summed over output blocks."""
        cfg = self.cfg
        ei = batch["edge_index"].long()
        valid = batch["edge_valid"].to(torch.float32)
        t_in = batch["triplet_in"].long()
        t_out = batch["triplet_out"].long()
        t_valid = batch["triplet_valid"].to(torch.float32)
        n = batch["positions"].shape[0]
        m = ei.shape[1]
        d = cfg.d_hidden

        vec, r = edge_vectors(batch)                  # j -> i displacement
        rbf = bessel_basis(r, cfg.n_radial, cfg.cutoff) @ self.rbf_lin

        h = self.species_embed[batch["species"].long()]
        if batch.get("node_feat") is not None and self.w_in is not None:
            h = h + batch["node_feat"] @ self.w_in

        msg = self.edge_mlp(torch.cat([h[ei[0]], h[ei[1]], rbf], -1),
                            final_act=True)           # (m, d)

        # triplet geometry: angle at j between (j->i) = edge t_out and (k->j)
        u_out = vec[t_out] / torch.clamp(r[t_out], min=1e-9)[:, None]
        u_in = -vec[t_in] / torch.clamp(r[t_in], min=1e-9)[:, None]
        cos_a = torch.clamp((u_out * u_in).sum(-1), -1.0, 1.0)
        sbf = self._sbf(r[t_in], cos_a) * t_valid[:, None]

        node_out = msg.new_zeros((n, d))
        for bp in self.blocks:
            # directional interaction: m_ji += Σ_k bilinear(sbf_kji, m_kj)
            s = sbf @ bp.w_sbf                               # (T, n_bilinear)
            if cfg.trip_proj_dim:
                # DimeNet++-style: project messages down to trip_proj_dim on
                # EDGES before the triplet gather
                mp = msg @ bp.w_msg[:, :cfg.trip_proj_dim]   # (m, p)
                m_in = mp[t_in] @ bp.w_proj_up               # (T, d)
            else:
                m_in = msg[t_in] @ bp.w_msg                  # (T, d)
            tp = torch.einsum("tb,td,bdf->tf", s, m_in, bp.w_bilinear)
            agg = segment_reduce(tp * t_valid[:, None], t_out, m)
            msg = msg @ bp.w_self + agg
            msg = msg + bp.mlp(F.silu(msg))
            msg = msg * valid[:, None]
            # output block: edge -> node
            node = segment_reduce(msg, ei[1], n)
            node_out = node_out + bp.out(node)
        return node_out
