"""MIND, the Multi-Interest Network with Dynamic Routing
[arXiv:1904.08030], as an ``nn.Module``.

User history -> item embeddings (a row gather) -> Behavior-to-Interest
(B2I) capsule dynamic routing (K interest capsules, ``capsule_iters``
rounds, squash) -> label-aware attention readout (training) or the best
interest's score (retrieval: one batched product against every candidate,
never a loop).

The parameters are named as the reference's tree (``item_embed``,
``s_matrix``, ``out_mlp_w``, ``out_mlp_b``), so ``models.params.
load_numpy_params`` carries it in.  Item ids index the table as torch
indexing does: an id in ``[-n_items, 0)`` wraps once, as ``jnp.take``
does, and an id outside ``[-n_items, n_items)`` raises (a device-side
assertion on CUDA), where ``jnp.take`` fills NaN.  Batches keep ids in
range.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import RecSysConfig
from repro_torch.device import resolve_device


def _squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-9
            ) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + eps)


def label_aware_attention(u: torch.Tensor, target_e: torch.Tensor,
                          p: float) -> torch.Tensor:
    """(B, K, d) x (B, d) -> (B, d): pow-sharpened attention over
    interests."""
    score = torch.einsum("bkd,bd->bk", u, target_e)
    att = torch.softmax(torch.pow(torch.abs(score) + 1e-9, p)
                        * torch.sign(score), dim=-1)
    return torch.einsum("bk,bkd->bd", att, u)


class MIND(nn.Module):
    """The reference's ``init_params`` draws on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, at the reference's scales:
    N(0, 1/d) for the item table, ``s_matrix`` and ``out_mlp_w``, zeros
    for ``out_mlp_b``."""

    def __init__(self, cfg: RecSysConfig, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.embed_dim
        self.cfg = cfg
        if dev.type == "meta":      # shapes and dtypes only, nothing drawn
            def normal(shape):
                return nn.Parameter(torch.empty(shape, device=dev))
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)

            def normal(shape):
                return nn.Parameter(torch.randn(shape, generator=gen,
                                                device=dev) * d ** -0.5)

        self.item_embed = normal((cfg.n_items, d))
        self.s_matrix = normal((d, d))
        self.out_mlp_w = normal((d, d))
        self.out_mlp_b = nn.Parameter(torch.zeros(d, device=dev))

    def interests(self, hist: torch.Tensor, hist_mask: torch.Tensor
                  ) -> torch.Tensor:
        """B2I dynamic routing: hist (B, T) item ids, hist_mask (B, T)
        float -> (B, K, d) interest capsules."""
        cfg = self.cfg
        b, t = hist.shape
        e = self.item_embed[hist.long()] * hist_mask[..., None]
        eh = e @ self.s_matrix                        # shared bilinear map
        blogit = torch.zeros((b, t, cfg.n_interests), dtype=torch.float32,
                             device=eh.device)
        u = None
        for _ in range(cfg.capsule_iters):
            w = torch.softmax(blogit, dim=-1) * hist_mask[..., None]
            u = _squash(torch.einsum("btk,btd->bkd", w, eh))
            blogit = blogit + torch.einsum("bkd,btd->btk", u, eh)
        return torch.relu(u @ self.out_mlp_w + self.out_mlp_b) + u

    def loss_fn(self, batch: dict):
        """Sampled softmax over the target and the shared negatives:
        (loss, {"loss": loss})."""
        u = self.interests(batch["hist"], batch["hist_mask"])
        tgt = self.item_embed[batch["target"].long()]             # (B, d)
        read = label_aware_attention(u, tgt, self.cfg.pow_p)      # (B, d)
        neg = self.item_embed[batch["negatives"].long()]          # (N, d)
        pos_logit = torch.sum(read * tgt, dim=-1, keepdim=True)   # (B, 1)
        logits = torch.cat([pos_logit, read @ neg.T], dim=-1)
        loss = (torch.logsumexp(logits, dim=-1) - pos_logit[:, 0]).mean()
        return loss, {"loss": loss}

    def serve(self, hist: torch.Tensor, hist_mask: torch.Tensor
              ) -> torch.Tensor:
        """Online inference: users -> K interest vectors (B, K, d)."""
        return self.interests(hist, hist_mask)

    def retrieval_scores(self, hist: torch.Tensor, hist_mask: torch.Tensor,
                         candidates: torch.Tensor) -> torch.Tensor:
        """(B, C): each candidate's best dot product over the user's
        interests, one (K, d) x (d, C) product per user."""
        u = self.interests(hist, hist_mask)                       # (B, K, d)
        ce = self.item_embed[candidates.long()]                   # (C, d)
        return torch.einsum("bkd,cd->bkc", u, ce).amax(dim=1)
