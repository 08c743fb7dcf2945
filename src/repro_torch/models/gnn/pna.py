"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

4 aggregators (mean/max/min/std) x 3 degree scalers (identity /
amplification log(d+1)/δ / attenuation δ/log(d+1)), concatenated and mixed
by an update MLP.  Message passing is the segment-reduction substrate
(graphs/segment.py); no sparse formats involved.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.graphs.segment import segment_reduce
from .common import (MLP, cross_entropy, input_embed, masked_dst,
                     masked_max_min, multi_aggregate, normal)


def _fused_aggregate(msg, ei, valid, n):
    """One scatter for [msg, msg^2, 1] (mean/std/count fused), one for
    max, one for min — 3 scatters instead of 5; all in ``msg``'s type."""
    d = msg.shape[1]
    dst = masked_dst(ei, valid, n)
    ones = valid.to(msg.dtype)[:, None]
    packed = torch.cat([msg * ones, (msg * msg) * ones, ones], dim=1)
    agg = segment_reduce(packed, dst, n)
    s, s2, cnt = agg[:, :d], agg[:, d:2 * d], agg[:, -1:]
    safe = torch.clamp(cnt, min=1.0)
    mean = s / safe
    std = torch.sqrt(torch.clamp(s2 / safe - mean * mean, min=0.0) + 1e-5)
    mmax, mmin = masked_max_min(msg, valid, dst, cnt, n)
    return mean, mmax, mmin, std


class PNALayer(nn.Module):
    def __init__(self, d: int, n_agg: int, gen: torch.Generator):
        super().__init__()
        self.msg = MLP((2 * d, d, d), gen)
        self.upd = MLP((d + n_agg * d, d, d), gen)


class PNA(nn.Module):
    def __init__(self, cfg: GNNConfig, d_feat: int, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_hidden
        n_agg = len(cfg.aggregators) * len(cfg.scalers)
        self.cfg = cfg
        self.w_in = normal(gen, (max(d_feat, 1), d), d_feat ** -0.5) \
            if d_feat else None
        self.species_embed = normal(gen, (cfg.n_species, d), 0.1)
        self.layers = nn.ModuleList(PNALayer(d, n_agg, gen)
                                    for _ in range(cfg.n_layers))
        self.head = MLP((d, d, cfg.n_classes), gen)

    def apply(self, batch):
        """The reference's name for ``forward`` (shadows
        ``nn.Module.apply``)."""
        return self(batch)

    def forward(self, batch) -> torch.Tensor:
        """-> node embeddings (n, d_hidden)."""
        cfg = self.cfg
        ei = batch["edge_index"].long()
        valid = batch["edge_valid"]
        n = (batch["node_feat"] if batch.get("node_feat") is not None
             else batch["species"]).shape[0]
        h = input_embed(self, batch)

        # degree scalers (log-degree relative to the batch average δ)
        deg = segment_reduce(valid.to(torch.float32), masked_dst(ei, valid, n),
                             n)
        logd = torch.log1p(deg)
        delta = torch.clamp(logd.mean(), min=1e-3)
        amp = (logd / delta)[:, None]
        att = (delta / torch.clamp(logd, min=1e-3))[:, None]

        for lp in self.layers:
            msg = lp.msg(torch.cat([h[ei[0]], h[ei[1]]], dim=-1),
                         final_act=True)
            if cfg.msg_dtype != "float32":
                # bf16 messages halve the scatter bytes
                msg = msg.to(getattr(torch, cfg.msg_dtype))
            if cfg.fused_stats:
                aggs4 = _fused_aggregate(msg, ei, valid, n)
            else:
                aggs4 = multi_aggregate(msg, ei, valid, n)[:4]
            aggs = []
            for agg in (a.to(h.dtype) for a in aggs4):  # mean, max, min, std
                for scale in (torch.ones_like(amp), amp, att):
                    aggs.append(agg * scale)
            h = h + lp.upd(torch.cat([h] + aggs, dim=-1))
        return h

    def node_logits(self, batch):
        return self.head(self(batch))

    def energy(self, batch):
        """Graph-level scalar (PNA's ZINC-style regression head): mean-pool
        per graph, reuse the head's first output unit."""
        val = self.head(self(batch))[:, 0]
        gid = batch.get("graph_ids")
        if gid is None:
            return val.mean()[None]
        nb = batch["n_graphs"]
        s = segment_reduce(val, gid, nb)
        c = segment_reduce(torch.ones_like(val), gid, nb)
        return s / torch.clamp(c, min=1.0)

    def loss_fn(self, batch):
        if "energy_target" in batch:
            e = self.energy(batch)
            return torch.mean((e - batch["energy_target"]) ** 2), {}
        return cross_entropy(self.node_logits(batch), batch["labels"],
                             batch.get("label_mask")), {}
