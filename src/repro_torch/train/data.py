"""Deterministic synthetic data pipelines (tokens / graphs / recsys).

Every pipeline is a pure function of (seed, step, shard), drawn with
numpy exactly as the JAX reference draws it, so both packages see the
same batches bit for bit and a run restarts from any step without state
files: worker w of W generates the same global batch slice regardless of
when it (re)joined.  Batches are int32/float32/bool tensors on ``device``
(``None`` means ``"cuda"``).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import RecSysConfig, TransformerConfig
from repro_torch.device import resolve_device


def _on(dev, arr, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=dtype),
                           device=dev)


def lm_batches(cfg: TransformerConfig, batch: int, seq: int, *,
               seed: int = 0, shard: int = 0, num_shards: int = 1,
               accum: int = 1, device=None) -> Iterator[dict]:
    """Zipf-distributed token stream (vocab-shaped like natural text)."""
    dev = resolve_device(device)
    local = batch // num_shards
    step = 0
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    while True:
        rng = np.random.default_rng((seed, step, shard))
        shape = (accum, local, seq + 1) if accum > 1 else (local, seq + 1)
        toks = rng.choice(cfg.vocab, size=shape, p=p).astype(np.int32)
        yield {"tokens": _on(dev, toks[..., :-1]),
               "targets": _on(dev, toks[..., 1:])}
        step += 1


def gnn_full_batches(n: int, m: int, d_feat: int, n_classes: int, *,
                     seed: int = 0, with_geom: bool = True,
                     max_triplets: int = 0, device=None) -> Iterator[dict]:
    from repro_torch.graphs.generators import power_law
    from repro_torch.models.gnn.common import build_triplets
    dev = resolve_device(device)
    src, dst = power_law(n, m, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ei = np.stack([src, dst])
    valid = np.ones(m, bool)
    batch = {
        "node_feat": _on(dev, rng.normal(size=(n, d_feat)), np.float32),
        "edge_index": _on(dev, ei),
        "edge_valid": _on(dev, valid),
        "species": _on(dev, rng.integers(0, 8, n), np.int32),
        "labels": _on(dev, rng.integers(0, n_classes, n), np.int32),
    }
    if with_geom:
        batch["positions"] = _on(dev, rng.normal(scale=2.0, size=(n, 3)),
                                 np.float32)
        if max_triplets:
            t_in, t_out, t_val = build_triplets(ei, valid, max_triplets)
            batch.update(triplet_in=_on(dev, t_in),
                         triplet_out=_on(dev, t_out),
                         triplet_valid=_on(dev, t_val))
    while True:
        yield batch


def recsys_batches(cfg: RecSysConfig, batch: int, *, seed: int = 0,
                   shard: int = 0, num_shards: int = 1,
                   device=None) -> Iterator[dict]:
    dev = resolve_device(device)
    local = batch // num_shards
    step = 0
    while True:
        rng = np.random.default_rng((seed, step, shard))
        hist = rng.integers(0, cfg.n_items, (local, cfg.hist_len))
        mask = (rng.random((local, cfg.hist_len)) < 0.9).astype(np.float32)
        mask[:, 0] = 1.0
        yield {
            "hist": _on(dev, hist, np.int32),
            "hist_mask": _on(dev, mask),
            "target": _on(dev, rng.integers(0, cfg.n_items, local),
                          np.int32),
            "negatives": _on(dev, rng.integers(0, cfg.n_items, cfg.n_neg),
                             np.int32),
        }
        step += 1
