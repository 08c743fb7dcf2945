"""Decoder-only transformer covering the five LM architectures of
``configs/``: GQA, QKV bias (qwen1.5), alternating local (sliding window)
and global attention with attention and final logit softcaps and sandwich
norms (gemma2), and MoE FFNs with shared experts (moonshot) or a parallel
dense-residual branch (arctic).

The parameters keep the reference's stacked layout: one (L, ...) tensor
per weight, named as its tree (``layers.attn.wq``, ``layers.mlp.w1``,
...), so ``models.params.load_numpy_params`` carries the reference's
``init_params`` tree in.  A Python loop runs the layers; ``cfg.remat``
recomputes each layer's activations in the backward pass
(``torch.utils.checkpoint``).  Weights are stored in ``cfg.param_dtype``
(norm scales, biases and the MoE router in float32) and cast to
``cfg.dtype`` where they are used.

``constrain(x, kind)`` is the reference's layout hook, the identity by
default.  Its ``"moe_call"`` kind receives ``(moe_params, tokens)`` and
may return ``(y, aux)`` to replace the local MoE FFN (a sharded MoE plugs
in there); returning its argument keeps the local one.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from .attention import chunked_attention, decode_attention, repeat_kv
from .moe import einsum, init_moe_params, moe_ffn, normal_
from .rope import apply_rope

Constrain = Callable[[torch.Tensor, str], torch.Tensor]


def _identity_constrain(x, kind):
    return x


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The ``(1 + w)`` RMSNorm, computed in float32."""
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((1.0 + w.to(torch.float32)) * n).to(x.dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    """``jax.nn.silu`` or ``jax.nn.gelu``, whose default is the tanh
    approximation."""
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def is_local_layers(cfg: TransformerConfig) -> list[bool]:
    """Per layer: sliding-window (local)?  The even layers of
    ``local_global``."""
    return [cfg.layer_pattern == "local_global" and i % 2 == 0
            for i in range(cfg.n_layers)]


def _embed(params, cfg, tokens, dt):
    """The embedding rows in ``dt``, scaled by sqrt(d_model) (rounded to
    ``dt``) under ``post_norm``."""
    x = params["embed"].to(dt)[tokens.long()]
    if cfg.post_norm:   # the scale rounded to dt on the host: no sync
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt).item()
    return x


# ------------------------------------------------------------------ forward
def _layer_fwd(cfg: TransformerConfig, x, lp, is_local, q_pos, kv_pos,
               constrain: Constrain, with_kv: bool = False):
    """One layer over a sequence: ``lp`` is ``{"attn": {...}, "mlp":
    {...}}`` of this layer's slices.  (x, aux, (k, v) or None)."""
    lp = constrain(lp, "layer_params")
    dt = x.dtype
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    a, m = lp["attn"], lp["mlp"]
    big = 1 << 30
    window = (cfg.window or (1 << 30)) if is_local else big

    hn = rmsnorm(x, a["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,de->bse", hn, a["wq"].to(dt))
    k = torch.einsum("bsd,de->bse", hn, a["wk"].to(dt))
    vv = torch.einsum("bsd,de->bse", hn, a["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + a["bq"].to(dt)
        k = k + a["bk"].to(dt)
        vv = vv + a["bv"].to(dt)
    q = apply_rope(q.reshape(b, s, h, dh), q_pos[None], cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kv, dh), kv_pos[None], cfg.rope_theta)
    vv = vv.reshape(b, s, kv, dh)
    kv_for_cache = (k, vv)   # GQA K/V before the repeat: what decode caches
    o = chunked_attention(q, repeat_kv(k, h // kv), repeat_kv(vv, h // kv),
                          q_pos, kv_pos, causal=True, window=window,
                          softcap=cfg.attn_softcap, kv_chunk=min(1024, s))
    o = torch.einsum("bse,ed->bsd", o.reshape(b, s, h * dh),
                     a["wo"].to(dt))
    if cfg.post_norm:
        o = rmsnorm(o, a["ln1_post"], cfg.norm_eps)
    x = constrain(x + o, "residual")

    hn2 = rmsnorm(x, m["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        up = torch.einsum("bsd,df->bsf", hn2, m["w1"].to(dt))
        gate = torch.einsum("bsd,df->bsf", hn2, m["w3"].to(dt))
        ff = (_act(cfg.act)(up.to(torch.float32))
              * gate.to(torch.float32)).to(dt)
        ff = torch.einsum("bsf,fd->bsd", ff, m["w2"].to(dt))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        # every weight in dt, except a float32 router, which stays float32
        mp = {k_: v_.to(dt) if v_.dtype != torch.float32 or k_ != "router"
              else v_ for k_, v_ in m.items() if k_ not in ("ln2", "ln2_post")}
        flat = hn2.reshape(b * s, d)
        hooked = constrain((mp, flat), "moe_call")
        if hooked is not None and not (isinstance(hooked, tuple)
                                       and len(hooked) == 2
                                       and hooked[0] is mp):
            ff, aux = hooked
        else:
            ff, aux = moe_ffn(mp, flat, cfg.moe, _act(cfg.act),
                              constrain=constrain)
        ff = ff.reshape(b, s, d)
    if cfg.post_norm:
        ff = rmsnorm(ff, m["ln2_post"], cfg.norm_eps)
    x = constrain(x + ff, "residual")
    return x, aux, (kv_for_cache if with_kv else None)


def _slice(tree: dict, i: int) -> dict:
    return {k: (_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


class Transformer(nn.Module):
    """The reference's ``init_params`` draws on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, at the reference's scales
    and dtypes: the embedding N(0, 0.02^2), the unembedding (untied
    configs) and the Q/K/V projections N(0, 1/d), the output projection
    N(0, 1/(H dh)), the FFN N(0, 1/d) in and N(0, 1/d_ff) out, the MoE as
    ``moe.init_moe_params``; norm scales and biases zero in float32.

    The methods are the reference's functions with ``params, cfg`` bound:
    ``forward``, ``forward_hidden``, ``loss_fn``, ``decode_step`` and
    ``prefill``; ``init_cache(cfg, batch, s_cache, device)`` stays a
    function, as in the reference.  On ``device="meta"`` nothing is
    drawn: the parameters have their shapes and dtypes and no values
    (the reference's ``jax.eval_shape(init_params)``)."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        l, d, h, kv, dh, f, v = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                                 cfg.vocab)
        pdt = _dtype(cfg.param_dtype)
        self.cfg = cfg

        def nrm(shape, scale):
            return nn.Parameter(normal_(torch.empty(shape, dtype=pdt,
                                                    device=dev), gen, scale))

        def zeros(shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=dev))

        s_in = d ** -0.5
        self.embed = nrm((v, d), 0.02)
        self.final_norm = zeros((d,))
        if not cfg.tie_embeddings:
            self.unembed = nrm((d, v), s_in)
        attn = {"wq": nrm((l, d, h * dh), s_in),
                "wk": nrm((l, d, kv * dh), s_in),
                "wv": nrm((l, d, kv * dh), s_in),
                "wo": nrm((l, h * dh, d), (h * dh) ** -0.5),
                "ln1": zeros((l, d))}
        if cfg.qkv_bias:
            attn.update(bq=zeros((l, h * dh)), bk=zeros((l, kv * dh)),
                        bv=zeros((l, kv * dh)))
        if cfg.post_norm:
            attn["ln1_post"] = zeros((l, d))
        if cfg.moe is None:
            mlp = {"w1": nrm((l, d, f), s_in), "w3": nrm((l, d, f), s_in),
                   "w2": nrm((l, f, d), f ** -0.5)}
        else:
            mlp = {k_: nn.Parameter(t) for k_, t in init_moe_params(
                gen, d, cfg.moe, pdt, lead=(l,), device=dev).items()}
        mlp["ln2"] = zeros((l, d))
        if cfg.post_norm:
            mlp["ln2_post"] = zeros((l, d))
        self.layers = nn.Module()
        self.layers.attn = nn.ParameterDict(attn)
        self.layers.mlp = nn.ParameterDict(mlp)

    @property
    def params(self) -> dict:
        """The parameter tree as the reference nests it."""
        p = {"embed": self.embed, "final_norm": self.final_norm,
             "layers": {"attn": dict(self.layers.attn),
                        "mlp": dict(self.layers.mlp)}}
        if not self.cfg.tie_embeddings:
            p["unembed"] = self.unembed
        return p

    # -------------------------------------------------------------- forward
    def _run_layers(self, tokens, constrain, with_kv):
        cfg = self.cfg
        params = self.params
        dt = _dtype(cfg.dtype)
        x = constrain(_embed(params, cfg, tokens, dt), "residual")
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=x.device)
        auxes, kvs = [], []
        for i, loc in enumerate(is_local_layers(cfg)):
            lp = _slice(params["layers"], i)

            def body(x, lp=lp, loc=loc):
                return _layer_fwd(cfg, x, lp, loc, pos, pos, constrain,
                                  with_kv)
            if cfg.remat and torch.is_grad_enabled():
                x, aux, kvp = checkpoint(body, x, use_reentrant=False)
            else:
                x, aux, kvp = body(x)
            auxes.append(aux)
            kvs.append(kvp)
        return x, torch.stack(auxes).sum(), kvs

    def forward(self, tokens: torch.Tensor, *,
                constrain: Constrain = _identity_constrain,
                with_kv: bool = False):
        """tokens (B, S) int -> (logits (B, S, V) in ``cfg.dtype``,
        aux_loss ()); with ``with_kv`` also the per-layer stacked (K, V),
        each (L, B, S, KV, dh): the prefill cache."""
        x, aux, kvs = self._run_layers(tokens, constrain, with_kv)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = _unembed(self.params, self.cfg, x, constrain)
        if with_kv:
            return logits, aux, (torch.stack([k for k, _ in kvs]),
                                 torch.stack([v for _, v in kvs]))
        return logits, aux

    def forward_hidden(self, tokens: torch.Tensor, *,
                       constrain: Constrain = _identity_constrain):
        """The forward up to the final norm: ((B, S, d), aux)."""
        x, aux, _ = self._run_layers(tokens, constrain, False)
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps), aux

    def loss_fn(self, tokens: torch.Tensor, targets: torch.Tensor, *,
                constrain: Constrain = _identity_constrain):
        """Cross-entropy plus the MoE aux loss: (loss, {"ce", "aux",
        "loss"}).  With ``0 < cfg.ce_chunk < S`` the unembedding and the
        CE run a chunk of ``ce_chunk`` positions at a time, so the
        (B, S, V) logits never exist whole."""
        cfg = self.cfg
        b, s = tokens.shape
        x, aux = self.forward_hidden(tokens, constrain=constrain)
        if cfg.ce_chunk and cfg.ce_chunk < s:
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for c0 in range(0, s // cfg.ce_chunk * cfg.ce_chunk,
                            cfg.ce_chunk):
                sl = slice(c0, c0 + cfg.ce_chunk)
                logits = _unembed(self.params, cfg, x[:, sl], constrain)
                total = total + _ce_terms(logits, targets[:, sl]).sum()
            ce = total / (b * s)
        else:
            logits = _unembed(self.params, cfg, x, constrain)
            ce = _ce_terms(logits, targets).mean()
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    # ----------------------------------------------------------- serve paths
    def decode_step(self, cache: dict, token: torch.Tensor, pos: int):
        """token (B,) int at absolute position ``pos`` -> (logits (B, V),
        the cache with the token's K/V written).  The caller's cache is
        not changed."""
        cfg = self.cfg
        params = self.params
        dt = _dtype(cfg.dtype)
        pos = int(pos)
        x = _embed(params, cfg, token, dt)[:, None, :]
        layers = params["layers"]
        if cfg.layer_pattern == "local_global":
            cache = {k_: t.clone() for k_, t in cache.items()}
            for i in range(cfg.n_layers // 2):
                x = _layer_decode(cfg, x, _slice(layers, 2 * i), pos,
                                  cache["k_local"][i], cache["v_local"][i],
                                  ring=True)
                x = _layer_decode(cfg, x, _slice(layers, 2 * i + 1), pos,
                                  cache["k_global"][i],
                                  cache["v_global"][i], ring=False)
        else:
            cache = {"k": cache["k"].clone(), "v": cache["v"].clone()}
            for i in range(cfg.n_layers):
                x = _layer_decode(cfg, x, _slice(layers, i), pos,
                                  cache["k"][i], cache["v"][i], ring=False)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return _unembed(params, cfg, x, dt=dt)[:, 0], cache

    def prefill(self, tokens: torch.Tensor, s_cache: int, *,
                constrain: Constrain = _identity_constrain):
        """Run the prompt and build the decode cache from the forward's
        per-layer K/V: (last logits (B, V), cache).  ``decode_step`` at
        ``pos = S`` continues from here."""
        cfg = self.cfg
        dt = _dtype(cfg.dtype)
        b, s = tokens.shape
        logits, _, (ks, vs) = self.forward(tokens, constrain=constrain,
                                           with_kv=True)  # (L, B, S, KV, dh)
        cache = init_cache(cfg, b, s_cache, device=self.embed.device)
        if cfg.layer_pattern == "local_global":
            w = cache["k_local"].shape[2]
            tail = min(s, w)
            slots = torch.arange(s - tail, s, device=ks.device) % w
            cache["k_local"][:, :, slots] = ks[0::2, :, s - tail:].to(dt)
            cache["v_local"][:, :, slots] = vs[0::2, :, s - tail:].to(dt)
            cache["k_global"][:, :, :s] = ks[1::2].to(dt)
            cache["v_global"][:, :, :s] = vs[1::2].to(dt)
        else:
            cache["k"][:, :, :s] = ks.to(dt)
            cache["v"][:, :, :s] = vs.to(dt)
        return logits[:, -1], cache


def _unembed(params, cfg, x, constrain: Constrain = _identity_constrain,
             dt=None):
    """Logits of ``x`` against the (un)embedding cast to ``dt`` (default
    ``x``'s dtype), softcapped under ``final_softcap``, in ``dt``."""
    dt = x.dtype if dt is None else dt
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", x, params["embed"].to(dt))
    else:
        logits = einsum("bsd,dv->bsv", x, params["unembed"].to(dt))
    logits = constrain(logits, "logits")
    if cfg.final_softcap is not None:
        logits = (cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)).to(dt)
    return logits


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy in float32: logsumexp minus the target's
    logit."""
    lf = logits.to(torch.float32)
    gold = lf.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def init_cache(cfg: TransformerConfig, batch: int, s_cache: int,
               device=None) -> dict:
    """Zero KV caches in ``cfg.dtype``: (L, B, S_cache, KV, dh) ``k`` and
    ``v``; under ``local_global`` ring buffers of min(window, S_cache)
    slots for the local (even) layers and S_cache slots for the global
    ones."""
    dt = _dtype(cfg.dtype)
    l, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head

    def z(n_layers, slots):
        return torch.zeros((n_layers, batch, slots, kv, dh), dtype=dt,
                           device=device)
    if cfg.layer_pattern == "local_global":
        w = min(cfg.window or s_cache, s_cache)
        lh = l // 2
        return {"k_local": z(lh, w), "v_local": z(lh, w),
                "k_global": z(l - lh, s_cache), "v_global": z(l - lh, s_cache)}
    return {"k": z(l, s_cache), "v": z(l, s_cache)}


def _project_qkv(cfg, a, x, pos_arr):
    dt = x.dtype
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hn = rmsnorm(x, a["ln1"], cfg.norm_eps)
    q = einsum("bsd,de->bse", hn, a["wq"].to(dt))
    k = einsum("bsd,de->bse", hn, a["wk"].to(dt))
    v = einsum("bsd,de->bse", hn, a["wv"].to(dt))
    if cfg.qkv_bias:
        q, k, v = (q + a["bq"].to(dt), k + a["bk"].to(dt),
                   v + a["bv"].to(dt))
    q = apply_rope(q.reshape(b, s, h, dh), pos_arr, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kv, dh), pos_arr, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, dh)


def _layer_decode(cfg, x, lp, pos: int, k_cache, v_cache, *, ring: bool):
    """One decode layer: write the token's K/V into this layer's cache (in
    place; a slot past the end is clamped to the last one, as
    ``dynamic_update_slice`` clamps), attend, FFN."""
    dt = x.dtype
    b = x.shape[0]
    a, m = lp["attn"], lp["mlp"]
    s_cache = k_cache.shape[1]
    slot = min(max(pos % s_cache if ring else pos, 0), s_cache - 1)
    q, k, v = _project_qkv(cfg, a, x, torch.full((1, 1), pos,
                                                  dtype=torch.int32,
                                                  device=x.device))
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos,
                         window=cfg.window if ring else None,
                         softcap=cfg.attn_softcap, ring=ring)
    o = einsum("bse,ed->bsd", o.reshape(b, 1, -1), a["wo"].to(dt))
    if cfg.post_norm:
        o = rmsnorm(o, a["ln1_post"], cfg.norm_eps)
    x = x + o
    hn2 = rmsnorm(x, m["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        up = einsum("bsd,df->bsf", hn2, m["w1"].to(dt))
        gate = einsum("bsd,df->bsf", hn2, m["w3"].to(dt))
        ff = (_act(cfg.act)(up.to(torch.float32))
              * gate.to(torch.float32)).to(dt)
        ff = einsum("bsf,fd->bsd", ff, m["w2"].to(dt))
    else:
        # only the weights that are not float32 are cast (decode's rule)
        mp = {k_: (v_ if v_.dtype == torch.float32 else v_.to(dt))
              for k_, v_ in m.items() if k_ not in ("ln2", "ln2_post")}
        ff, _ = moe_ffn(mp, hn2.reshape(b, -1), cfg.moe, _act(cfg.act))
        ff = ff.reshape(b, 1, -1)
    if cfg.post_norm:
        ff = rmsnorm(ff, m["ln2_post"], cfg.norm_eps)
    return x + ff
