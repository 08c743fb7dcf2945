"""The reference against networkx on small graphs, clean and after
deletes, and the ledger's snapshots."""
from __future__ import annotations

import networkx as nx
import numpy as np
import pytest
import torch

from reachbench import reference
from reachbench.gen import chung_lu
from reachbench.traffic import Ledger


def _nx_reach(n, src, dst, u, v):
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from(zip(src.tolist(), dst.tolist()))
    return np.array([nx.has_path(g, a, b) for a, b in zip(u, v)])


@pytest.mark.parametrize("trial", range(8))
def test_reference_agrees_with_networkx(trial):
    rng = np.random.default_rng(trial)
    n = int(rng.integers(2, 80))
    m = int(rng.integers(0, 300))
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    u, v = rng.integers(0, n, 150), rng.integers(0, n, 150)
    got = reference.reach(torch.tensor(src), torch.tensor(dst), n,
                          torch.tensor(u), torch.tensor(v)).numpy()
    assert (got == _nx_reach(n, src, dst, u, v)).all()


def test_distances_are_shortest_path_lengths():
    rng = np.random.default_rng(11)
    n, m = 60, 150
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    u, v = rng.integers(0, n, 300), rng.integers(0, n, 300)
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from(zip(src.tolist(), dst.tolist()))
    want = [nx.shortest_path_length(g, a, b) if nx.has_path(g, a, b)
            else -1 for a, b in zip(u, v)]
    got = reference.distances(torch.tensor(src), torch.tensor(dst), n,
                              torch.tensor(u), torch.tensor(v)).tolist()
    assert got == want


def test_reference_blocks_and_groups(monkeypatch):
    # lanes across several groups and edges across several blocks
    monkeypatch.setattr(reference, "EDGE_BLOCK", 7)
    monkeypatch.setattr(reference, "LANES", 5)
    rng = np.random.default_rng(3)
    n, m = 50, 200
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    u, v = rng.integers(0, n, 37), rng.integers(0, n, 37)
    got = reference.reach(torch.tensor(src), torch.tensor(dst), n,
                          torch.tensor(u), torch.tensor(v)).numpy()
    assert (got == _nx_reach(n, src, dst, u, v)).all()


def test_snapshots_after_inserts_and_deletes():
    n, m, extra = 300, 700, 200
    src, dst = chung_lu(n, m, extra, beta=1.0, i0=5, perm="independent",
                        seed=4, device="cpu")
    led = Ledger.of(src, dst, m)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, n, 200), rng.integers(0, n, 200)
    snaps = [led.t]
    dels = []
    for _ in range(3):
        s, d = led.take_deletes(60, gen)
        assert len(set(zip(s.tolist(), d.tolist()))) == 60
        dels.append((s, d))
        led.take_inserts(50)
        snaps.append(led.t)
    all_s, all_d = src.numpy(), dst.numpy()
    for t in snaps:
        live = led.live_at(t).numpy()
        got = reference.reach(src[led.live_at(t)], dst[led.live_at(t)], n,
                              torch.tensor(u), torch.tensor(v)).numpy()
        want = _nx_reach(n, all_s[live], all_d[live], u, v)
        assert (got == want).all()
    # the live set at the end: the graph and the inserts, minus the deletes
    live = led.live_at(led.t).numpy()
    assert live.sum() == m + 150 - 180
    gone = {(a, b) for s, d in dels for a, b in zip(s.tolist(), d.tolist())}
    assert not any((a, b) in gone for a, b in
                   zip(all_s[live].tolist(), all_d[live].tolist()))


def test_deletes_draw_only_live_edges():
    src, dst = chung_lu(200, 500, 0, beta=1.0, i0=5, perm="shared", seed=2,
                        device="cpu")
    led = Ledger.of(src, dst, 500)
    gen = torch.Generator().manual_seed(1)
    seen = set()
    for _ in range(5):
        s, d = led.take_deletes(90, gen)
        pairs = set(zip(s.tolist(), d.tolist()))
        assert len(pairs) == 90 and not pairs & seen
        seen |= pairs
    assert int(led.live_at(led.t).sum()) == 50
