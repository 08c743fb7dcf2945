"""On the card (``chip``): every call that makes the host wait for the card
inside ``QueryEngine.query``/``insert``/``delete`` and
``ReachabilityServer.delete`` falls inside a ``repro_torch.sync.*`` span,
and a sync span holds one such call, so the ``sync`` spans count the
serving path's host waits.  PyTorch's sync debug mode warns on each
synchronising call.  Skips without a card; on the
card run ``python3 -m pytest -q -s -m chip tests/test_torch_tracing_chip.py``
(it imports no JAX, which the card's machine lacks)."""
import collections
import contextlib
import functools
import traceback
import warnings

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.dbl import DBLIndex
from repro_torch.core.graph import make_graph
from repro_torch.graphs.generators import power_law
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.reach_server import ReachabilityServer

N, M = 6000, 40000

#: sync spans whose one library call waits for the card more than once
#: inside (``isin`` sorts and takes unique values)
MANY_WAITS = {"repro_torch.sync.delete_match"}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """This file runs no JAX: nothing to reset (overrides the suite's
    fixture, which imports it)."""
    yield


class Open:
    """Stands in for the profiler's range: keeps the spans open now, as
    (name, the span's number), and counts the spans entered by name."""

    def __init__(self):
        self.open, self.entered = [], collections.Counter()

    @contextlib.contextmanager
    def __call__(self, name):
        self.open.append((name, sum(self.entered.values())))
        self.entered[name] += 1
        try:
            yield
        finally:
            self.open.pop()


def _scoped(fn, depth):
    @functools.wraps(fn)
    def call(*a, **kw):
        depth[0] += 1
        try:
            return fn(*a, **kw)
        finally:
            depth[0] -= 1
    return call


#: (plane representation, label families) of each served layout
CASES = {"bool": ("bool", ("dl", "bl")), "packed": ("packed", ("dl", "bl")),
         "il": ("bool", ("dl", "bl", "il"))}


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CASES))
def test_every_sync_of_the_served_path_is_in_a_sync_span(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    plane_repr, families = CASES[case]
    src, dst = power_law(N, M, seed=1)
    g = make_graph(src, dst, N, m_cap=M + 2000, device=dev)
    idx = DBLIndex.build(g, n_cap=N, k=64, k_prime=64, check="raise",
                         plane_repr=plane_repr, families=families,
                         device=dev)
    eng = QueryEngine(idx, bfs_chunk=64, bfs_kernel=True,
                      plane_repr=plane_repr,
                      frontier_dtype="packed" if plane_repr == "packed"
                      else "int8")
    srv = ReachabilityServer(None, engine=eng, rebuild_dead_ratio=0.25)
    eng.warmup(idx, batch_sizes=(2000,), bfs_buckets=eng._chunk_buckets())
    torch.cuda.synchronize()
    depth = [0]
    for name in ("query", "insert", "delete"):
        monkeypatch.setattr(eng, name, _scoped(getattr(eng, name), depth))
    monkeypatch.setattr(srv, "delete", _scoped(srv.delete, depth))
    spans = Open()
    monkeypatch.setattr(tracing, "_range", spans)
    monkeypatch.setattr(tracing, "_recording", lambda: True)
    seen, outside = collections.Counter(), collections.Counter()
    per_span = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message) or not depth[0]:
            return
        inner = spans.open[-1] if spans.open else ("-", None)
        where = "".join(traceback.format_stack(limit=4)[:-1])
        if inner[0].startswith("repro_torch.sync."):
            seen[inner[0]] += 1
            per_span[inner] += 1
        else:
            outside[(inner[0], where)] += 1

    rng = np.random.default_rng(2)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            for step in range(3):
                srv.query(rng.integers(0, N, 2000), rng.integers(0, N, 2000))
                ns, nd = rng.integers(0, N, 100), rng.integers(0, N, 100)
                srv.insert(ns, nd)
                srv.query(rng.integers(0, N, 2000), rng.integers(0, N, 2000))
                srv.delete(ns[:50], nd[:50])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"\n{case}: syncs / spans by name "
          + str({name: f"{n}/{spans.entered[name]}"
                 for name, n in seen.items()}))
    for (inner, where), n in outside.items():
        print(f"{case}: {n} outside a sync span, in {inner}:\n{where}")
    assert seen["repro_torch.sync.bfs_go"] > 0
    assert seen["repro_torch.sync.fixpoint_go"] > 0
    assert not outside, list(outside)
    several = {name for (name, _), n in per_span.items()
               if n > 1 and name not in MANY_WAITS}
    assert not several, several
