"""DBL x GNN composition on the PyTorch port: train PNA on minibatches whose
neighbour sampling is *reachability-filtered* by a live DBL index while the
graph grows.  Each round samples 32 seeds with fanouts 5 and 3, keeps a
sampled edge only if the index certifies that its source reaches one of
the four most in-connected vertices, takes one SGD step (``w - 0.05 g``) on
the node-classification loss, then inserts 20 random edges.

    PYTHONPATH=src python examples/gnn_reachability_torch.py [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import pna as cfg_pna
from repro_torch.core import DBLIndex, make_graph
from repro_torch.device import resolve_device
from repro_torch.graphs.generators import power_law
from repro_torch.graphs.sampler import CSR, reachability_filtered_sample
from repro_torch.models.params import load_numpy_params, sgd_step
from repro_torch.models.gnn.pna import PNA

N, M, D_FEAT, N_CLASSES = 3_000, 18_000, 16, 8
SEEDS, FANOUTS, TARGETS, INSERTS, LR = 32, [5, 3], 4, 20, 0.05


def subgraph_to_batch(sub, feats, labels, device):
    src = np.concatenate([b.src for b in sub.blocks])
    dst = np.concatenate([b.dst for b in sub.blocks])
    val = np.concatenate([b.edge_valid for b in sub.blocks])
    return {
        "node_feat": torch.as_tensor(feats[sub.nodes], device=device),
        "edge_index": torch.as_tensor(np.stack([src, dst]), device=device),
        "edge_valid": torch.as_tensor(val, device=device),
        "species": torch.zeros(len(sub.nodes), dtype=torch.int32,
                               device=device),
        "labels": torch.as_tensor(labels[sub.nodes], device=device),
    }


def run(device=None, params=None, rounds=5):
    """[(kept, total, loss)] per round.  ``params``: a PNA parameter tree
    of numpy arrays to start from (``load_numpy_params``); else the
    model's own seeded init."""
    dev = resolve_device(device)
    src, dst = power_law(N, M, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, N).astype(np.int32)

    g = make_graph(src, dst, N, m_cap=M + 500, device=dev)
    idx = DBLIndex.build(g, n_cap=N, k=32, k_prime=32, max_iters=64,
                         device=dev)
    csr = CSR.from_edges(N, src, dst)
    # targets = the most in-connected hubs (reachable from a large basin);
    # random vertices in a sparse digraph are reachable from almost nowhere
    in_deg = np.bincount(dst, minlength=N)
    targets = np.argsort(-in_deg)[:TARGETS].astype(np.int32)

    model = PNA(cfg_pna.SMOKE.scaled(n_classes=N_CLASSES), D_FEAT).to(dev)
    if params is not None:
        load_numpy_params(model, params)
    out = []
    for _ in range(rounds):
        seeds = rng.choice(N, SEEDS, replace=False)
        sub = reachability_filtered_sample(csr, seeds, FANOUTS, idx, targets,
                                           rng=rng)
        kept = sum(int(b.edge_valid.sum()) for b in sub.blocks)
        total = sum(len(b.edge_valid) for b in sub.blocks)
        loss, _ = model.loss_fn(subgraph_to_batch(sub, feats, labels, dev))
        loss.backward()
        sgd_step(model, LR)
        # the graph grows; DBL keeps the filter fresh without a rebuild
        ns = rng.integers(0, N, INSERTS).astype(np.int32)
        nd = rng.integers(0, N, INSERTS).astype(np.int32)
        idx = idx.insert_edges(ns, nd, max_iters=64)
        out.append((kept, total, float(loss.detach())))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for r, (kept, total, loss) in enumerate(run(args.device)):
        print(f"round {r}: kept {kept}/{total} sampled edges "
              f"(reachability-filtered), loss {loss:.3f}, "
              f"+{INSERTS} edges inserted")
    print("OK")


if __name__ == "__main__":
    main()
