"""Attention: GQA with causal and sliding-window masks, a logit softcap,
and the chunked (online-softmax) formulation whose memory is
O(S x kv_chunk): full (B, H, S, S) scores never exist, only one
(B, Sq, H, kv_chunk) tile per kv chunk.

Written in torch ops, one Python loop over kv chunks; the reference's
formulation is kept (``F.scaled_dot_product_attention`` has no softcap).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, KV*n_rep, dh)."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


def _mask_tile(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
               window) -> torch.Tensor:
    """(Sq, Skv) bool, True = attend.  ``window``: None or an int."""
    rel = q_pos[:, None] - kv_pos[None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok &= rel >= 0
    if window is not None:
        ok &= rel < window
    return ok


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window=None,
                      softcap: float | None = None,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention.

    q (B, Sq, H, dh); k, v (B, Skv, H, dh), KV already GQA-repeated;
    q_pos (Sq,), kv_pos (Skv,) absolute positions for the masks.
    Returns (B, Sq, H, dh) in q's dtype.  ``Skv`` must be a multiple of
    ``min(kv_chunk, Skv)``."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    kv_chunk = min(kv_chunk, skv)
    if skv % kv_chunk:
        raise ValueError(f"Skv={skv} is not a multiple of kv_chunk="
                         f"{kv_chunk}")
    qf = (q * dh ** -0.5).to(torch.float32)
    acc = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, kv_chunk):
        k_i = k[:, c0:c0 + kv_chunk].to(torch.float32)
        v_i = v[:, c0:c0 + kv_chunk].to(torch.float32)
        s = _softcap(torch.einsum("bqhd,bchd->bqhc", qf, k_i), softcap)
        mask = _mask_tile(q_pos, kv_pos[c0:c0 + kv_chunk], causal=causal,
                          window=window)
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum("bqhc,bchd->bqhd", p,
                                                    v_i)
        denom = denom * alpha + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int | None = None,
                     softcap: float | None = None,
                     ring: bool = False) -> torch.Tensor:
    """One token's attention against a KV cache.

    q (B, 1, H, dh); caches (B, S_cache, KV, dh), GQA (not repeated);
    ``pos`` the current absolute position.  ``ring=True``: the cache is a
    ring buffer of S_cache == window slots (local layers), every live slot
    in the window by construction.  Returns (B, 1, H, dh)."""
    b, s_cache, kv, dh = k_cache.shape
    h = q.shape[2]
    qg = (q[:, 0] * dh ** -0.5).to(torch.float32).reshape(b, kv, h // kv, dh)
    s = _softcap(torch.einsum("bknd,bskd->bkns", qg,
                              k_cache.to(torch.float32)), softcap)
    slot = torch.arange(s_cache, device=q.device)
    if ring:
        valid = slot < min(pos + 1, s_cache)
    else:
        valid = slot <= pos
        if window is not None:
            valid &= slot > pos - window
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkns,bskd->bknd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, dh).to(q.dtype)
