"""MACE — higher-order equivariant message passing [arXiv:2206.07697].

Per layer: (1) the A-basis — the same radial x spherical-harmonic CG
convolution as NequIP — then (2) the B-basis: symmetric tensor powers of A
up to correlation order ν (default 3) built by iterated channel-wise CG
products, each projected back to the target irreps with learnable channel
mixes.  Two layers suffice (the paper's point: higher correlation order
replaces deep stacks).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import GNNConfig
from .common import MLP, Potential, normal, per_l
from .nequip import (cg, embed_geometry, init_common, paths, register_cg,
                     tp_convolution)


def _pair_paths(l_max: int):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for lo in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                out.append((l1, l2, lo))
    return out


class MACELayer(nn.Module):
    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        c = cfg.d_hidden
        pp = _pair_paths(cfg.l_max)

        def mat(_=None):
            return normal(gen, (c, c), c ** -0.5)

        self.radial = MLP((cfg.n_rbf, 64, len(paths(cfg.l_max)) * c), gen)
        # B-basis channel mixers per correlation order and output l
        self.mix_b2 = nn.ParameterDict({f"{l1}_{l2}_{lo}": mat()
                                        for (l1, l2, lo) in pp})
        self.mix_b3 = nn.ParameterDict({f"{l1}_{l2}_{lo}": mat()
                                        for (l1, l2, lo) in pp})
        self.lin_b1 = per_l(cfg.l_max, mat)
        self.lin_b2 = per_l(cfg.l_max, mat)
        self.lin_b3 = per_l(cfg.l_max, mat)
        self.skip = per_l(cfg.l_max, mat)


class MACE(Potential):
    def __init__(self, cfg: GNNConfig, d_feat: int, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        init_common(self, cfg, d_feat, gen)
        self.layers = nn.ModuleList(MACELayer(cfg, gen)
                                    for _ in range(cfg.n_layers))
        register_cg(self, sorted(set(paths(cfg.l_max))
                                 | set(_pair_paths(cfg.l_max))))

    def _tensor_power(self, a, b, mix):
        """Channel-wise CG product of irrep dicts a ⊗ b with learnable
        mixing."""
        out = {l: torch.zeros_like(a[l]) for l in range(self.cfg.l_max + 1)}
        for (l1, l2, lo) in _pair_paths(self.cfg.l_max):
            prod = torch.einsum("nci,ncj,ijk->nck", a[l1], b[l2],
                                cg(self, l1, l2, lo))
            out[lo] = out[lo] + torch.einsum("nci,cd->ndi", prod,
                                             mix[f"{l1}_{l2}_{lo}"])
        return out

    def forward(self, batch) -> torch.Tensor:
        cfg = self.cfg
        ei, sh, rbf, feat, norm = embed_geometry(self, cfg, batch)
        valid = batch["edge_valid"]
        n = feat[0].shape[0]
        for lp in self.layers:
            a = tp_convolution(self, cfg, lp.radial, feat, ei, valid, sh,
                               rbf, n)
            a = {l: v * norm for l, v in a.items()}
            b2 = self._tensor_power(a, a, lp.mix_b2)           # ν = 2
            b3 = (self._tensor_power(b2, a, lp.mix_b3)         # ν = 3
                  if cfg.correlation_order >= 3 else None)
            new = {}
            for l in range(cfg.l_max + 1):
                k = str(l)
                m = torch.einsum("nci,cd->ndi", a[l], lp.lin_b1[k])
                m = m + torch.einsum("nci,cd->ndi", b2[l], lp.lin_b2[k])
                if b3 is not None:
                    m = m + torch.einsum("nci,cd->ndi", b3[l], lp.lin_b3[k])
                new[l] = m + torch.einsum("nci,cd->ndi", feat[l],
                                          lp.skip[k])
            feat = {0: F.silu(new[0][:, :, 0])[:, :, None],
                    **{l: new[l] for l in range(1, cfg.l_max + 1)}}
        return feat[0][:, :, 0]
