"""The port's AOT cache (``repro_torch.serve.aot``): the engine's label
phase and residue programs exported with ``torch.export``, saved, and
loaded again in this process and in a fresh one, with answers held
bitwise against the JAX package's ``QueryEngine``, the port's live engine
and the dense oracle (twins of ``tests/test_engine.py``'s AOT tests, plus
inserts and deletes on a hit engine, a fresh process, the kernels' op
nodes and the CLI)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import DBLIndex as JIndex
from repro.core import make_graph as j_make_graph
from repro.graphs.generators import power_law
from repro.serve.engine import QueryEngine as JEngine
from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import distributed as D
from repro_torch.core import make_graph as t_make_graph
from repro_torch.serve import aot
from repro_torch.serve import reach_server
from repro_torch.serve.engine import QueryEngine as TEngine
from tests.conftest import reach_oracle

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
OPS = {"verdicts": "repro_torch.dbl_query_verdicts.default",
       "streamed_verdicts": "repro_torch.dbl_query_verdicts_streamed.default",
       "admit": "repro_torch.bfs_admit_plane.default",
       "streamed_admit": "repro_torch.bfs_admit_plane_streamed.default"}
RELAX_OP = "repro_torch.bfs_relax.default"


def _edges(n, m, m_extra):
    src, dst = power_law(n, m, seed=5)
    return np.asarray(src, np.int32), np.asarray(dst, np.int32), m + m_extra


def _t_index(n=256, m=1200, *, k=8, kp=8, m_extra=64, max_iters=64):
    src, dst, m_cap = _edges(n, m, m_extra)
    g = t_make_graph(src, dst, n, m_cap=m_cap, device=CPU)
    idx = TIndex.build(g, n_cap=n, k=k, k_prime=kp, max_iters=max_iters,
                       device=CPU)
    return idx, src, dst


def _j_index(n=256, m=1200, *, k=8, kp=8, m_extra=64, max_iters=64):
    src, dst, m_cap = _edges(n, m, m_extra)
    g = j_make_graph(src, dst, n, m_cap=m_cap)
    return JIndex.build(g, n_cap=n, k=k, k_prime=kp, max_iters=max_iters)


def _files(path):
    return sorted(Path(path).glob(f"*{aot.SUFFIX}"))


def _loaded_calls(eng):
    calls = [eng._label_phase.loaded_calls]
    for prologue, round_ in eng._coal_phases.values():
        calls += [prologue.loaded_calls, round_.loaded_calls]
    return sum(calls)


def test_aot_cache_round_trip(tmp_path):
    """The first engine exports its label phase and residue programs; a
    second loads every one and misses none, and answers as the first, the
    JAX engine and the oracle do; a third stores nothing."""
    idx, src, dst = _t_index()
    rng = np.random.default_rng(11)
    u = rng.integers(0, 256, 700).astype(np.int32)
    v = rng.integers(0, 256, 700).astype(np.int32)
    sizes = (1, 700)

    e1 = TEngine(idx, bfs_chunk=64, max_iters=64)
    e1.aot_warmup(idx, tmp_path, batch_sizes=sizes)
    assert e1.aot_cache.stores > 0 and e1.aot_cache.hits == 0
    files = _files(tmp_path)
    assert len(files) == e1.aot_cache.stores
    base = e1.run(idx, u, v)

    e2 = TEngine(idx, bfs_chunk=64, max_iters=64)
    e2.aot_warmup(idx, tmp_path, batch_sizes=sizes)
    assert e2.aot_cache.hits == e1.aot_cache.stores \
        and e2.aot_cache.misses == 0
    got = e2.run(idx, u, v)
    assert e2._label_phase.loaded_calls == 1
    assert e2._label_phase.live_calls == 0
    assert _loaded_calls(e2) > 1
    np.testing.assert_array_equal(base, got)
    want = JEngine(_j_index(), bfs_chunk=64, max_iters=64).run(
        _j_index(), u, v)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, reach_oracle(256, src, dst)[u, v])
    # no index array is a constant of a program: they are its inputs
    for f in files:
        ep = torch.export.load(f)
        assert all(t.numel() < 64 for t in ep.constants.values()
                   if isinstance(t, torch.Tensor)), f.name

    e3 = TEngine(idx, bfs_chunk=64, max_iters=64)
    e3.aot_warmup(idx, tmp_path, batch_sizes=sizes)
    assert e3.aot_cache.stores == 0
    assert len(_files(tmp_path)) == len(files)


def test_aot_cache_corrupt_entry_degrades_to_miss(tmp_path):
    idx, _, _ = _t_index(n=64, m=160, m_extra=8, max_iters=40)
    e1 = TEngine(idx, bfs_chunk=32, max_iters=40)
    e1.aot_warmup(idx, tmp_path)
    for f in _files(tmp_path):
        f.write_bytes(b"garbage")
    e2 = TEngine(idx, bfs_chunk=32, max_iters=40)
    with pytest.warns(aot.AOTCacheWarning):
        e2.aot_warmup(idx, tmp_path)
    assert e2.aot_cache.hits == 0     # every entry degraded to a miss
    assert e2.aot_cache.misses == e1.aot_cache.stores
    rng = np.random.default_rng(3)
    u = rng.integers(0, 64, 128).astype(np.int32)
    ans = e2.run(idx, u, u)           # serving still works (live phases)
    assert ans.all()


def test_aot_rejects_meshed_layouts(tmp_path):
    idx, _, _ = _t_index(n=64, m=160, m_extra=8, max_iters=40)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        for kw in (dict(vertex_mesh=D.vertex_mesh(1, device=CPU)),
                   dict(mesh=D.query_mesh(1, device=CPU))):
            eng = TEngine(idx, bfs_chunk=32, max_iters=40, **kw)
            with pytest.raises(ValueError, match="replicated"):
                eng.aot_warmup(eng.index, tmp_path / "cache")
    finally:
        dist.destroy_process_group()
    assert not _files(tmp_path / "cache")


def _late_pairs(idx, src, dst, count=20):
    """(sources, landmark): ``count`` sources that do not reach the
    index's first landmark, which an insert of source -> landmark edges
    makes reachable (and label-positive: the landmark is in its own
    DL_in row)."""
    lm = int(idx.landmarks[0])
    cut = ~reach_oracle(256, src, dst)[:, lm]
    cut[lm] = False
    return np.flatnonzero(cut)[:count].astype(np.int32), lm


def _stream(eng, rng, n, src, dst, late):
    """Clean query; submit -> insert -> submit -> flush with the late
    pairs in both submits (as of submit, the first sees them unreachable:
    stale lanes whose labels now say yes); a delete; a dirty query.  The
    answers in order."""
    a, lm = late
    out = [np.asarray(eng.query(rng.integers(0, n, 500),
                                rng.integers(0, n, 500)))]
    u = np.concatenate([a, rng.integers(0, n, 500 - a.size)])
    v = np.concatenate([np.full(a.size, lm), rng.integers(0, n, 500 - a.size)])
    p1 = eng.submit(eng.index, u, v)
    eng.insert(np.concatenate([a, rng.integers(0, n, 20)]).astype(np.int32),
               np.concatenate([np.full(a.size, lm),
                               rng.integers(0, n, 20)]).astype(np.int32))
    p2 = eng.submit(eng.index, u, v)
    out += [np.asarray(x) for x in eng.flush([p1, p2])]
    eng.delete(src[:60], dst[:60])
    out.append(np.asarray(eng.query(rng.integers(0, n, 500),
                                    rng.integers(0, n, 500))))
    return out


@pytest.mark.parametrize("knobs", [
    {}, dict(bfs_kernel=True, frontier_dtype="packed")],
    ids=["default", "admit-packed"])
def test_aot_hit_engine_through_inserts_and_deletes(tmp_path, knobs):
    """An engine on loaded programs answers a stream with stale lanes
    after an insert and dirty labels after a delete bitwise as the JAX
    engine does: a baked edge count, or a clean program run dirty, would
    show here."""
    kw = dict(bfs_chunk=64, max_iters=64, donate=False, **knobs)
    idx, src, dst = _t_index()
    late = _late_pairs(idx, src, dst)
    TEngine(idx, **kw).aot_warmup(idx, tmp_path, batch_sizes=(500,))
    eng = TEngine(_t_index()[0], **kw)
    eng.aot_warmup(eng.index, tmp_path, batch_sizes=(500,))
    assert eng.aot_cache.misses == 0
    got = _stream(eng, np.random.default_rng(4), 256, src, dst, late)
    assert _loaded_calls(eng) > 3
    # the dirty flag is an input of the programs: a dirty dispatch
    # reaches the same loaded program as a clean one
    assert eng._label_phase.live_calls == 0
    k = late[0].size
    assert not got[1][:k].any() and got[2][:k].all()
    want = _stream(JEngine(_j_index(), **kw), np.random.default_rng(4),
                   256, src, dst, late)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")
    live = _stream(TEngine(_t_index()[0], **kw), np.random.default_rng(4),
                   256, src, dst, late)
    for a, b in zip(got, live):
        np.testing.assert_array_equal(a, b)


_CHILD = """
import json, sys
import numpy as np
import torch
from repro_torch.core import DBLIndex, make_graph
from repro_torch.serve import aot
from repro_torch.serve.engine import QueryEngine
path, streaming = sys.argv[1], sys.argv[2] == "1"
# the import above registered the ops and the dataclasses: every file
# loads before any cache or engine exists
for f in sorted(__import__("pathlib").Path(path).glob("*.pt2")):
    torch.export.load(f).module()
e = np.load(sys.argv[3])
g = make_graph(e["src"], e["dst"], 256, m_cap=int(e["m_cap"]), device="cpu")
idx = DBLIndex.build(g, n_cap=256, k=8, k_prime=8, max_iters=64,
                     device="cpu")
eng = QueryEngine(idx, bfs_chunk=64, max_iters=64, bfs_kernel=True,
                  streaming=streaming)
eng.aot_warmup(idx, path, batch_sizes=(300,))
rng = np.random.default_rng(9)
ans = eng.run(idx, rng.integers(0, 256, 300), rng.integers(0, 256, 300))
print(json.dumps({"hits": eng.aot_cache.hits,
                  "misses": eng.aot_cache.misses,
                  "stores": eng.aot_cache.stores,
                  "loaded_label": eng._label_phase.loaded_calls,
                  "answers": ans.astype(int).tolist()}))
"""


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["grid", "streamed"])
def test_aot_programs_hold_kernel_ops_and_load_in_a_fresh_process(
        tmp_path, streaming):
    """With ``bfs_kernel=True`` the exported graphs call the kernels as
    ``repro_torch`` op nodes (the label phase the verdict op, the residue
    prologue the verdict and admit ops, the BFS round the relax op); a
    fresh process, which registers
    the ops and the dataclasses at import, loads every file and answers
    as this one does."""
    idx, _, _ = _t_index()
    eng = TEngine(idx, bfs_chunk=64, max_iters=64, bfs_kernel=True,
                  streaming=streaming)
    eng.aot_warmup(idx, tmp_path, batch_sizes=(300,))
    targets = {}
    for rec in eng.aot_cache.log:
        ep = torch.export.load(tmp_path / f"{rec['key']}{aot.SUFFIX}")
        targets[rec["tag"]] = {str(n.target) for n in ep.graph.nodes
                               if n.op == "call_function"}
    pre = "streamed_" if streaming else ""
    assert OPS[pre + "verdicts"] in targets["label"]
    assert OPS[pre + "verdicts"] in targets["coalesced-64"]
    assert OPS[pre + "admit"] in targets["coalesced-64"]
    other = "" if streaming else "streamed_"
    assert not any(OPS[other + k] in t for k in ("verdicts", "admit")
                   for t in targets.values())
    assert not any(o in targets["bfs-round-64"] for o in OPS.values())
    # each bucket's round relaxes through its own op, taken whole
    for tag, t in targets.items():
        assert (RELAX_OP in t) == tag.startswith("bfs-round-"), tag
    rng = np.random.default_rng(9)
    want = eng.run(idx, rng.integers(0, 256, 300), rng.integers(0, 256, 300))

    src, dst, m_cap = _edges(256, 1200, 64)
    np.savez(tmp_path / "edges.npz", src=src, dst=dst, m_cap=m_cap)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path), str(int(streaming)),
         str(tmp_path / "edges.npz")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["hits"] == eng.aot_cache.stores and got["misses"] == 0
    assert got["stores"] == 0 and got["loaded_label"] == 1
    np.testing.assert_array_equal(np.array(got["answers"], bool), want)


def test_cli_aot_cache_second_run_hits_every_store(tmp_path, capsys):
    args = ["--device", "cpu", "--n", "256", "--m", "1200", "--k", "8",
            "--rounds", "2", "--batch", "128", "--aot-cache",
            str(tmp_path)]
    reach_server.main(args)
    first = json.loads(capsys.readouterr().out)
    reach_server.main(args)
    second = json.loads(capsys.readouterr().out)
    assert first["engine"]["aot"]["stores"] > 0
    assert first["engine"]["aot"]["hits"] == 0
    assert second["engine"]["aot"] == {
        "hits": first["engine"]["aot"]["stores"], "misses": 0, "stores": 0}
    assert len(_files(tmp_path)) == first["engine"]["aot"]["stores"]
    for k in ("queries", "rho", "inserts"):
        assert first[k] == second[k]


def test_dispatcher_key_must_name_what_differs():
    """A dispatch key that does not tell two input signatures apart is
    refused when the second program is added; calls route by the key."""
    def key(x, flag):
        return bool(flag)
    d = aot.ShapeDispatcher(lambda x, flag: "live", key)
    d.add((torch.zeros(4), False), lambda x, flag: "loaded")
    d.add((torch.ones(4), False), lambda x, flag: "loaded again")
    with pytest.raises(ValueError, match="two input signatures"):
        d.add((torch.zeros(8), False), lambda x, flag: "other")
    assert d(torch.zeros(4), False) == "loaded again"
    assert d(torch.zeros(4), True) == "live"
    assert (d.loaded_calls, d.live_calls) == (1, 1)


def test_phase_graph_made_once_a_graph():
    """The residue phases' graph (``m``, ``del_epoch`` as 0-d tensors) is
    made once for each bound graph, and anew after an insert or a
    delete, with the new counts."""
    idx, src, dst = _t_index()
    eng = TEngine(idx, bfs_chunk=64, max_iters=64)
    g = eng.index.graph
    pg = eng._phase_graph(g)
    assert eng._phase_graph(g) is pg
    assert int(pg.m) == g.m and int(pg.del_epoch) == g.del_epoch
    assert pg.src is g.src
    eng.insert(np.array([1, 2], np.int32), np.array([3, 4], np.int32))
    eng.delete(src[:3], dst[:3])
    g2 = eng.index.graph
    pg2 = eng._phase_graph(g2)
    assert pg2 is not pg
    assert int(pg2.m) == g2.m == g.m + 2
    assert int(pg2.del_epoch) == g2.del_epoch == g.del_epoch + 1
