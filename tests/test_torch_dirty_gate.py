"""The dirty flag as an input of the port's query phases: ``d_stale`` is a
0-d bool tensor (``QueryEngine._dirty_gate``) that the label phase, the
coalesced residue's prologue and its rounds read on the device, as the
reference's compiled phases read their traced ``d_stale``.  So one
exported program serves clean and dirty labels, ``aot_warmup`` covers
dirty rounds and ``warmup`` warms both states.

Held here, at n 256 and ``bfs_chunk`` 64: an engine on loaded AOT
programs through a stream of clean, stale and dirty batches and a
rebuild, with no live dispatch, bitwise against the JAX engine; the
phases given the gate against the same phases given a host bool and
against the host-branch algebra of ``core.query``; dispatch shapes after
``warmup``, a dirty round and a rebuild against the reference's; and a
cache entry in the clean-only format is a miss."""
import numpy as np
import pytest
import torch

from repro.core import DBLIndex as JIndex
from repro.core import make_graph as j_make_graph
from repro.graphs.generators import power_law
from repro.serve.engine import QueryEngine as JEngine
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import make_graph as t_make_graph
from repro_torch.core import query as Q
from repro_torch.kernels.dbl_query.ops import StreamILFallbackWarning
from repro_torch.serve import aot
from repro_torch.serve.engine import QueryEngine as TEngine
from tests.test_torch_dispatch_shapes import TorchAPI, jax_api

N, M, M_EXTRA = 256, 1200, 64
CHUNK, ITERS = 64, 64
IL = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=0)


def _edges():
    src, dst = power_law(N, M, seed=5)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def _t_index(il):
    src, dst = _edges()
    g = t_make_graph(src, dst, N, m_cap=M + M_EXTRA, device="cpu")
    return TIndex.build(g, n_cap=N, k=8, k_prime=8, max_iters=ITERS,
                        device="cpu", **(IL if il else {}))


def _j_index(il):
    src, dst = _edges()
    g = j_make_graph(src, dst, N, m_cap=M + M_EXTRA)
    return JIndex.build(g, n_cap=N, k=8, k_prime=8, max_iters=ITERS,
                        **(IL if il else {}))


def _stream(eng):
    """A clean query; submit, insert, submit, flush (stale lanes); a
    delete and a dirty query and flush of two submits; a full rebuild and
    a clean query.  The answers in order."""
    rng = np.random.default_rng(4)
    src, dst = _edges()

    def pair(q):
        return rng.integers(0, N, q), rng.integers(0, N, q)

    out = [eng.query(*pair(500))]
    u, v = pair(500)
    p1 = eng.submit(eng.index, u, v)
    eng.insert(*(x.astype(np.int32) for x in pair(20)))
    p2 = eng.submit(eng.index, u, v)
    out += eng.flush([p1, p2])
    eng.delete(src[:60], dst[:60])
    out.append(eng.query(*pair(500)))
    out += eng.flush([eng.submit(eng.index, *pair(300)),
                      eng.submit(eng.index, *pair(40))])
    eng.rebuild(mode="full")
    out.append(eng.query(*pair(500)))
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module")
def jax_answers():
    return {il: _stream(JEngine(_j_index(il), bfs_chunk=CHUNK,
                                max_iters=ITERS))
            for il in (False, True)}


def _dispatchers(eng):
    return [eng._label_phase] + [d for pair in eng._coal_phases.values()
                                 for d in pair]


@pytest.mark.parametrize("bfs_kernel,streaming,frontier,il", [
    (False, False, "int8", False),
    (True, False, "int8", True),
    (True, True, "packed", False),
    (False, True, "int8", False),
    (True, False, "packed", False),
    (False, False, "packed", True),
    (True, True, "int8", True),
], ids=lambda x: str(x))
def test_loaded_programs_serve_dirty_rounds(tmp_path, jax_answers,
                                            bfs_kernel, streaming, frontier,
                                            il):
    """After ``aot_warmup`` from a cache a first engine wrote, every
    dispatch of the stream (clean, stale, dirty, rebuilt) reaches a
    loaded program, and the answers equal the JAX engine's bitwise."""
    kw = dict(bfs_chunk=CHUNK, max_iters=ITERS, bfs_kernel=bfs_kernel,
              streaming=streaming, frontier_dtype=frontier)
    with pytest.warns(StreamILFallbackWarning) if streaming and il \
            else _no_warning():
        first = TEngine(_t_index(il), **kw)
        first.aot_warmup(first.index, tmp_path, batch_sizes=(500, 300, 40))
        eng = TEngine(_t_index(il), **kw)
        eng.aot_warmup(eng.index, tmp_path, batch_sizes=(500, 300, 40))
        assert eng.aot_cache.misses == 0
        assert eng.aot_cache.hits == first.aot_cache.stores
        got = _stream(eng)
    assert eng.stats.rebuilds == 1 and eng.stats.bfs_dispatches > 0
    assert sum(d.live_calls for d in _dispatchers(eng)) == 0
    assert eng._label_phase.loaded_calls == 7
    for i, (a, b) in enumerate(zip(got, jax_answers[il])):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _host_label(p, u, v, dirty, il):
    """The label phase's verdicts by the host-branch algebra: a Python
    bool ``d_fresh``, and the interval rule dropped while dirty."""
    return Q.cut_verdicts(p, u, v, Q.FRESH_CUT, 0, not dirty, il=il)


def _host_residue(g, p, il, uu, vv, m_cut, dirty, max_iters):
    """A residue chunk by the host-branch algebra: the re-check with a
    Python bool ``d_fresh`` and ``pruned_bfs`` with a bool ``dl_clean``
    and no interval planes while dirty."""
    n_cap = p.dl_in.shape[0]
    live = uu < n_cap
    uu_safe = uu.clamp(max=n_cap - 1)
    verd = Q.cut_verdicts(p, uu_safe, vv, m_cut, g.m, not dirty, il=il)
    uu2 = torch.where(live & (verd == -1), uu, torch.full_like(uu, n_cap))
    hit = Q.pruned_bfs(g, p, uu2, vv, None, m_cut, not dirty,
                       None if dirty else il, n_cap=n_cap,
                       max_iters=max_iters)
    return ((verd == 1) & live) | hit


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("bfs_kernel,frontier", [
    (False, "int8"), (True, "int8"), (True, "packed")])
def test_phases_on_the_gate_equal_the_host_branch(bfs_kernel, frontier):
    """``label_phase`` and ``coalesced_prologue`` given the 0-d gate equal
    the same phases given the host bool, and the host-branch algebra, on
    clean and dirty labels of an "il" index, with stale and fresh lanes;
    the gate is made once for each index state."""
    eng = TEngine(_t_index(True), bfs_chunk=CHUNK, max_iters=ITERS,
                  bfs_kernel=bfs_kernel, frontier_dtype=frontier)
    rng = np.random.default_rng(8)
    u = torch.from_numpy(rng.integers(0, N, 512).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, N, 512).astype(np.int32))
    src, dst = _edges()
    eng.insert(np.array([1, 2, 3], np.int32), np.array([7, 8, 9], np.int32))
    for dirty in (False, True):
        if dirty:
            eng.delete(src[:60], dst[:60])
        idx = eng.index
        assert idx.is_dirty == dirty
        gate = eng._dirty_gate(idx)
        assert gate.shape == () and gate.dtype == torch.bool
        assert bool(gate) == dirty and eng._dirty_gate(idx) is gate
        p, il = idx.packed, idx.il
        on_gate = eng.label_phase(p, u, v, gate, il)
        _same(on_gate, eng.label_phase(p, u, v, dirty, il))
        verd = _host_label(p, u, v, dirty, il)
        assert torch.equal(on_gate[0], verd == 1)
        assert int(on_gate[4]) == int((verd == -1).sum())
        g = eng._phase_graph(idx.graph)
        for c in (16, CHUNK):
            uu = u[:c].clone()
            uu[::5] = N                                     # dead lanes
            m_cut = torch.full((c,), Q.FRESH_CUT, dtype=torch.int32)
            m_cut[1::3] = idx.graph.m - 3                   # stale lanes
            args = (g, p, il, uu, v[:c], m_cut)
            on_gate = eng.coalesced_prologue(*args, gate)
            _same(on_gate, eng.coalesced_prologue(*args, dirty))
            hits = eng.coalesced_phase(idx, uu, v[:c], m_cut, gate)
            want = _host_residue(idx.graph, p, il, uu, v[:c], m_cut, dirty,
                                 ITERS)
            assert torch.equal(hits, want)
    eng.rebuild()
    assert not bool(eng._dirty_gate(eng.index))


def _gate_shapes(api):
    """``dirty_flips``' index and engine: dispatch shapes after
    ``warmup``, after a dirty round, after a rebuild and a clean round."""
    rng = np.random.default_rng(0)
    n = 48
    src = rng.integers(0, n, 160).astype(np.int32)
    dst = rng.integers(0, n, 160).astype(np.int32)
    idx = api.index(src, dst, n, 224, k=4, k_prime=4, max_iters=50)
    eng = api.Engine(idx, bfs_chunk=32, max_iters=50)
    eng.warmup(idx, batch_sizes=(600,), bfs_buckets=(16, 32))
    counts = [eng.dispatch_shape_counts()]
    u = rng.integers(0, n, 600).astype(np.int32)
    v = rng.integers(0, n, 600).astype(np.int32)
    eng.delete(src[:30], dst[:30])
    assert eng.index.is_dirty
    ans = [np.asarray(eng.query(u, v))]
    counts.append(eng.dispatch_shape_counts())
    eng.rebuild()
    ans.append(np.asarray(eng.query(u, v)))
    counts.append(eng.dispatch_shape_counts())
    return counts, ans


def test_warmup_then_dirty_round_adds_no_shape():
    """``warmup`` on clean labels, then a dirty round and a rebuilt one:
    no new dispatch shape, and counts and answers equal the reference's."""
    got, ans = _gate_shapes(TorchAPI)
    want, want_ans = _gate_shapes(jax_api())
    assert got == want
    assert got[0] == got[1] == got[2] == {"label": 1, "bfs": 2}
    for a, b in zip(ans, want_ans):
        np.testing.assert_array_equal(a, b)


def test_clean_only_cache_entry_is_a_miss(tmp_path):
    """An entry written in the clean-only format (the dirty flag a host
    ``False`` baked into the program) is keyed on other avals, so an
    engine that takes the gate as an input misses it and stores its own;
    the old program has one tensor input fewer."""
    idx = _t_index(False)
    old = TEngine(idx, bfs_chunk=CHUNK, max_iters=ITERS)
    cache = aot.AOTCache(tmp_path)
    config = old._aot_config(idx)
    i32 = dict(dtype=torch.int32)
    c = CHUNK
    phase_g = old._phase_graph(idx.graph)
    entries = {
        "label": (old.label_phase,
                  (idx.packed, torch.zeros(c, **i32), torch.zeros(c, **i32),
                   False, idx.il)),
        f"coalesced-{c}": (old.coalesced_prologue,
                           (phase_g, idx.packed, idx.il,
                            torch.full((c,), N, **i32), torch.zeros(c, **i32),
                            torch.full((c,), Q.FRESH_CUT, **i32), False))}
    old_keys = {}
    for tag, (fn, args) in entries.items():
        old_keys[tag] = cache.key(tag, old.backend, args, config=config)
        cache.store(old_keys[tag], fn, args, tag)
    assert cache.stores == 2

    eng = TEngine(idx, bfs_chunk=CHUNK, max_iters=ITERS)
    eng.aot_warmup(idx, tmp_path, batch_sizes=(1,), bfs_buckets=(c,))
    assert eng.aot_cache.hits == 0
    assert eng.aot_cache.misses == eng.aot_cache.stores == 3
    new_keys = {r["tag"]: r["key"] for r in eng.aot_cache.log}
    for tag, key in old_keys.items():
        assert new_keys[tag] != key
        assert _tensor_inputs(tmp_path / f"{new_keys[tag]}{aot.SUFFIX}") \
            == _tensor_inputs(tmp_path / f"{key}{aot.SUFFIX}") + 1, tag


def _tensor_inputs(path) -> int:
    """The number of tensor user inputs of a saved program (a host bool
    is a constant input)."""
    from torch.export.graph_signature import InputKind, TensorArgument
    specs = torch.export.load(path).graph_signature.input_specs
    return sum(s.kind == InputKind.USER_INPUT
               and isinstance(s.arg, TensorArgument) for s in specs)
