"""Batched autoregressive serving on the transformer's decode path:
prefill the prompts, then one ``decode_step`` a token, greedy or sampled.

Sampling draws exactly what ``jax.random.categorical`` draws for the same
key: ``rng, sub = split(rng)`` a step, then the argmax of the logits plus
Gumbel noise ``-log(-log(u))``, with ``u`` JAX's uniform in
``[tiny, 1)`` made from the threefry bit stream of ``sub``
(``core/_threefry.py``).  A key is the pair of uint32 words
``_threefry.seed_key(seed)`` gives, as ``jax.random.PRNGKey(seed)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import _threefry

#: the unsigned and signed integer types of a float's width
_UINT = {16: np.uint16, 32: np.uint32}
_INT = {16: torch.int16, 32: torch.int32}


def uniform(key, shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval=finfo(dtype).tiny,
    maxval=1)`` for a 16- or 32-bit float type: the mantissa bits of 1.0
    filled from the top of the random words (8 bits a word for types with
    fewer than 8 mantissa bits), minus 1, then scaled into ``[tiny,
    1)``."""
    fi = torch.finfo(dtype)
    nbits = fi.bits
    nmant = int(round(-np.log2(fi.eps)))
    rng_bits = 8 if nmant < 8 else nbits
    bits = _threefry.random_bits(key, shape).astype(np.uint64) \
        & np.uint64((1 << rng_bits) - 1)
    one = int(torch.tensor(1.0, dtype=dtype).view(_INT[nbits]).item()) \
        & ((1 << nbits) - 1)
    fbits = ((bits >> np.uint64(rng_bits - nmant)) | np.uint64(one)) \
        .astype(_UINT[nbits])
    floats = torch.from_numpy(fbits.view(f"int{nbits}")).to(device) \
        .view(dtype) - torch.tensor(1.0, dtype=dtype, device=device)
    lo = torch.tensor(fi.tiny, dtype=dtype, device=device)
    span = torch.tensor(1.0, dtype=dtype, device=device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(key, shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` (its default "low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, dtype, device)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis."""
    g = gumbel(key, tuple(logits.shape), logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=-1)


def serve_step(model, cache: dict, token: torch.Tensor, pos: int):
    """One token for the whole batch against the full cache: the unit a
    decode server runs, (logits (B, V), cache')."""
    return model.decode_step(cache, token, pos)


def generate(model, prompts: torch.Tensor, n_steps: int, *,
             s_cache: int | None = None, greedy: bool = True,
             rng=None) -> torch.Tensor:
    """prompts (B, S) -> (B, n_steps) generated ids, greedy or sampled
    (``rng``: a key, needed when ``greedy`` is False)."""
    b, s = prompts.shape
    s_cache = s_cache or (s + n_steps)
    with torch.no_grad():
        last_logits, cache = model.prefill(prompts, s_cache)
        outs = []
        tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
        for i in range(n_steps):
            outs.append(tok)
            logits, cache = serve_step(model, cache, tok, s + i)
            if greedy:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                rng, sub = _threefry.split2(rng)
                tok = categorical(sub, logits).to(torch.int32)
    return torch.stack(outs, dim=1)
