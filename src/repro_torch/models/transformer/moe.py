"""Mixture-of-Experts FFN: token-choice top-k routing, sort-based dispatch.

Slots are sorted by expert (a stable sort), placed by their rank within
their expert, gathered into an (E, C, d) buffer, run through one grouped
GLU, and combined back with their gate weights; a slot ranked at or past
the capacity C is dropped.  There is no (T, E, C) one-hot product.

Covers moonshot (64 experts, top 6, shared experts) and arctic (128
experts, top 2, a parallel dense-residual branch).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on the two operands promoted to one dtype, as
    ``jnp.einsum`` promotes them (bfloat16 with float32 gives float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _glu(x, w1, w3, w2, act):
    h = einsum("...d,df->...f", x, w1)
    g = einsum("...d,df->...f", x, w3)
    h = (act(h.to(torch.float32)) * g.to(torch.float32)).to(x.dtype)
    return einsum("...f,fd->...d", h, w2)


def _counts(se: torch.Tensor, e: int) -> torch.Tensor:
    """Slots per expert, (E,) int64 (``torch.bincount`` would read its
    input's max back to the host)."""
    return torch.zeros(e, dtype=torch.int64, device=se.device).scatter_add_(
        0, se, torch.ones_like(se))


def route(params: dict, x: torch.Tensor, cfg: MoEConfig,
          capacity: int | None = None) -> dict:
    """The routing of ``moe_ffn``: router probabilities, the top-k slots
    in expert order and which of them fit the capacity.  A dict of
    ``c`` (capacity), ``probs`` (T, E), ``order`` (T*K,) the stable sort
    of the slots by expert, ``se`` the sorted experts, ``tok`` and
    ``gate`` each sorted slot's token and normalised gate, ``pos`` its
    rank within its expert and ``keep`` = ``pos < c``."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    c = capacity or max(8, int(t * k / e * cfg.capacity_factor))
    logits = einsum("td,de->te", x, params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k)                         # (T, K)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    slot_e = eidx.reshape(-1)
    order = torch.argsort(slot_e, stable=True)
    se = slot_e[order]
    counts = _counts(se, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=x.device) - starts[se]
    return dict(c=c, probs=probs, order=order, se=se,
                tok=order // k,
                gate=gates.reshape(-1)[order], pos=pos, keep=pos < c)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, act, *,
            capacity: int | None = None,
            constrain=lambda x, kind: x) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d), aux_loss ()).  The capacity is
    ``max(8, int(T*K/E*capacity_factor))`` unless given.

    ``constrain(arr, kind)`` sees the big dispatch intermediates ("moe_buf"
    for the (E, C, d) expert buffer, "moe_tokens" for the (T*K, d) slot
    array); identity by default."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(params, x, cfg, capacity)
    c, se, keep = r["c"], r["se"], r["keep"]
    tk = t * k
    dev = x.device

    # buffer row of each sorted slot; a dropped slot goes to the spare row
    # e*c, which is cut off (the reference's scatter drops it)
    row = torch.where(keep, se * c + r["pos"], e * c)
    fill = torch.full((e * c + 1,), tk, dtype=torch.int64, device=dev)
    fill[row] = torch.arange(tk, device=dev)            # row -> source slot
    fill = fill[:e * c]
    src_tok = r["tok"][torch.clamp(fill, max=tk - 1)]
    buf = torch.where((fill < tk)[:, None], x[src_tok], 0)
    buf = constrain(buf.reshape(e, c, d), "moe_buf")

    h = einsum("ecd,edf->ecf", buf, params["w1"])
    g = einsum("ecd,edf->ecf", buf, params["w3"])
    h = (act(h.to(torch.float32)) * g.to(torch.float32)).to(x.dtype)
    out = constrain(einsum("ecf,efd->ecd", h, params["w2"]), "moe_buf")

    gate_s = torch.where(keep, r["gate"], 0.0).to(x.dtype)
    vals = constrain(out.reshape(e * c, d)[torch.clamp(row, max=e * c - 1)]
                     * gate_s[:, None], "moe_tokens")    # (T*K, d)
    # combine: invert the sort, then sum each token's K slots
    inv_order = torch.empty(tk, dtype=torch.int64, device=dev)
    inv_order[r["order"]] = torch.arange(tk, device=dev)
    y = vals[inv_order].reshape(t, k, d).sum(dim=1)

    # Switch-style load-balance auxiliary
    f_e = _counts(se, e).to(torch.float32) / tk
    p_e = r["probs"].mean(dim=0)
    aux = cfg.router_aux_weight * e * torch.sum(f_e * p_e)

    if cfg.n_shared > 0:
        y = y + _glu(x, params["shared_w1"], params["shared_w3"],
                     params["shared_w2"], act)
    if cfg.dense_residual:
        y = y + _glu(x, params["dense_w1"], params["dense_w3"],
                     params["dense_w2"], act)
    return y, aux


def normal_(out: torch.Tensor, gen: torch.Generator, scale: float,
            chunk: int = 1 << 26) -> torch.Tensor:
    """Fill ``out`` in place with N(0, scale^2) drawn in float32 on its
    device, then cast to its dtype, a chunk of elements at a time (a
    full-width expert stack never exists in float32).  A meta tensor is
    returned as it is (``gen`` may then be None)."""
    if out.is_meta:
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), chunk):
        n = min(chunk, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=out.device) \
            * scale
    return out


def init_moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig,
                    dtype, *, lead: tuple = (), device=None) -> dict:
    """One MoE FFN's parameters (the reference's tree and scales), each
    with the leading dims ``lead`` (``(n_layers,)`` stacks the layers):
    a float32 router N(0, 1/d), experts in ``dtype`` N(0, 1/d) in and
    N(0, 1/d_ff) out; shared experts and the dense branch likewise."""
    e, f = cfg.n_experts, cfg.d_ff
    lead = tuple(lead)

    def nrm(shape, scale, dt=dtype):
        return normal_(torch.empty(lead + shape, dtype=dt, device=device),
                       gen, scale)

    s_in = d_model ** -0.5
    p = {
        "router": nrm((d_model, e), s_in, torch.float32),
        "w1": nrm((e, d_model, f), s_in),
        "w3": nrm((e, d_model, f), s_in),
        "w2": nrm((e, f, d_model), f ** -0.5),
    }
    if cfg.n_shared > 0:
        fs = cfg.d_ff * cfg.n_shared
        p["shared_w1"] = nrm((d_model, fs), s_in)
        p["shared_w3"] = nrm((d_model, fs), s_in)
        p["shared_w2"] = nrm((fs, d_model), fs ** -0.5)
    if cfg.dense_residual:
        fd = cfg.dense_d_ff or cfg.d_ff
        p["dense_w1"] = nrm((d_model, fd), s_in)
        p["dense_w3"] = nrm((d_model, fd), s_in)
        p["dense_w2"] = nrm((fd, d_model), fd ** -0.5)
    return p
