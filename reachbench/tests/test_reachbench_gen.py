"""The generator: deterministic in the seed, distinct pairs, no self-loop,
held-out edges apart from the graph."""
from __future__ import annotations

import pytest
import torch

from reachbench.gen import chung_lu, weights

N, M, EXTRA = 2000, 9000, 3000


@pytest.mark.parametrize("perm", ["shared", "independent"])
def test_same_seed_same_edges(perm):
    a = chung_lu(N, M, EXTRA, beta=1.1, i0=10, perm=perm, seed=2**31 + 5,
                 device="cpu")
    b = chung_lu(N, M, EXTRA, beta=1.1, i0=10, perm=perm, seed=2**31 + 5,
                 device="cpu")
    c = chung_lu(N, M, EXTRA, beta=1.1, i0=10, perm=perm, seed=2**31 + 6,
                 device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("perm,beta", [("shared", 1.1),
                                       ("independent", 0.84)])
def test_distinct_edges_no_self_loops(perm, beta):
    src, dst = chung_lu(N, M, EXTRA, beta=beta, i0=10, perm=perm, seed=1,
                        device="cpu")
    assert src.dtype == dst.dtype == torch.int32
    assert src.numel() == dst.numel() == M + EXTRA
    assert int(src.min()) >= 0 and int(src.max()) < N
    assert int(dst.min()) >= 0 and int(dst.max()) < N
    assert not bool((src == dst).any())
    keys = src.long() * N + dst.long()
    assert torch.unique(keys).numel() == M + EXTRA


def test_held_out_apart_from_graph():
    src, dst = chung_lu(N, M, EXTRA, beta=1.1, i0=10, perm="shared",
                        seed=9, device="cpu")
    keys = src.long() * N + dst.long()
    assert not bool(torch.isin(keys[M:], keys[:M]).any())


def test_graph_does_not_depend_on_how_many_are_held_out_in_size():
    # the same seed with another held-out count still gives m graph edges
    src, _ = chung_lu(N, M, 0, beta=1.1, i0=10, perm="shared", seed=9,
                      device="cpu")
    assert src.numel() == M


def test_weights_fall_with_rank():
    w = weights(100, 1.1, 10, "cpu")
    assert bool((w[1:] < w[:-1]).all())
    assert float(w[0]) == pytest.approx(10 ** -1.1)


def test_refuses_more_edges_than_the_vertices_hold():
    with pytest.raises(ValueError):
        chung_lu(10, 40, 0, beta=1.0, i0=1, perm="shared", seed=0,
                 device="cpu")
    with pytest.raises(ValueError):
        chung_lu(100, 10, 0, beta=1.0, i0=1, perm="twisted", seed=0,
                 device="cpu")


@pytest.mark.parametrize("perm,beta", [("shared", 1.1),
                                       ("independent", 1.3)])
def test_every_vertex_has_an_edge(perm, beta):
    # steep weights leave many vertices without a drawn edge; each gets one
    src, dst = chung_lu(N, M, EXTRA, beta=beta, i0=10, perm=perm, seed=3,
                        device="cpu", core=20)
    deg = torch.bincount(src[:M].long(), minlength=N) + \
        torch.bincount(dst[:M].long(), minlength=N)
    assert int((deg == 0).sum()) == 0
    keys = src.long() * N + dst.long()
    assert torch.unique(keys).numel() == M + EXTRA
    assert not bool((src == dst).any())


def test_first_query_batch_after_updates_reads_them_back():
    from .conftest import run_tiny, tiny
    res = run_tiny("wikitalk.churn")
    per = tiny("wikitalk.churn")[2]["read_your_writes"]
    led = res["ledger"]
    keys = led.src.long() * 400 + led.dst.long()
    sizes = [a.read_u.size for a in res["answered"]]
    # delete, insert, then four query batches: the first reads both back
    assert sizes[:8] == [2 * per, 0, 0, 0] * 2
    for a in res["answered"]:
        if not a.read_u.size:
            continue
        k = torch.from_numpy(a.read_u.astype("int64") * 400
                             + a.read_v.astype("int64"))
        slot = torch.nonzero(keys[None, :] == k[:, None])[:, 1]
        assert slot.numel() == 2 * per
        assert bool((led.died[slot[:per]] == a.t - 1).all())  # deleted
        assert bool((led.born[slot[per:]] == a.t).all())      # inserted
