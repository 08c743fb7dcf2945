"""The port's auto-partitioned scheme (``core.distributed``'s
``index_shardings``, ``shard_index``, ``distributed_build``,
``distributed_insert``) over gloo ranks on the CPU, held bitwise against
the JAX package's replicated index.

The twin of ``tests/distributed/run_multidevice.py``, on its inputs
(``power_law(512, 4096, seed=3)``, m_cap m + 64, k = k' = 16, max_iters 64,
``default_rng(0)``).  The file is also the script that runs the ranks:
pytest starts ``python tests/test_torch_gspmd.py <out_dir>``, which spawns
a world of 4 gloo ranks on a (2, 2) launch mesh and then a world of one
on a (1, 1) mesh (the harness of ``tests/test_torch_sharded_planes.py``),
and ``python tests/test_torch_gspmd.py --jax <out>``, the JAX package on 4
forced host devices for the placements (``layout_of`` and the layout
specs).  Each rank writes its blocks and answers of every step; meanwhile
pytest runs the same steps on the JAX package's replicated index, then
concatenates the blocks in rank order and compares.
"""
import json
import os
import subprocess
import sys
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import distributed as TD
from repro_torch.core import graph as TG
from repro_torch.core import planes as TPL
from repro_torch.core.dbl import LabelSaturationError, LabelSaturationWarning
from repro_torch.graphs.generators import power_law
from repro_torch.launch.mesh import Mesh, make_mesh_compat
from repro_torch.launch.sharding import (P, reach_halo_shardings,
                                         reach_place_index,
                                         reach_query_shardings,
                                         reach_vertex_shardings)
from repro_torch.serve.engine import QueryEngine as TEngine
from tests.test_torch_sharded_planes import (GROUP_TIMEOUT_S, RUN_TIMEOUT_S,
                                             WORLD, _bits, start_world)

N, M = 512, 4096
KW = dict(k=16, k_prime=16, max_iters=64)
FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=0)
PLANES = ("dl_in", "dl_out", "bl_in", "bl_out")
#: row-split leaves of the scheme, by the reference's field names
BLOCKS = (*PLANES, *(f"packed.{p}" for p in PLANES), "bl_sources",
          "bl_sinks", "graph.src", "graph.dst", "graph.del_at")
WHOLE = ("landmarks", "graph.n", "graph.m", "graph.del_epoch", "epoch",
         "label_del_epoch", "saturated")
#: a max_iters the 64-edge insert's fixpoints do not converge within
SAT_ITERS = 1


def inputs():
    """run_multidevice.py's graph, queries and batches, in its draw
    order."""
    src, dst = power_law(N, M, seed=3)
    rng = np.random.default_rng(0)
    u = rng.integers(0, N, 4096).astype(np.int32)
    v = rng.integers(0, N, 4096).astype(np.int32)
    ns = rng.integers(0, N, 64).astype(np.int32)
    nd = rng.integers(0, N, 64).astype(np.int32)
    u2 = rng.integers(0, N, 1024).astype(np.int32)
    v2 = rng.integers(0, N, 1024).astype(np.int32)
    return src, dst, u, v, ns, nd, u2, v2


# ------------------------------------------------------------ the ranks
def _leaf(idx, name):
    obj = idx
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def put_index(rec, step, idx):
    """The rank's block of every split leaf and the whole fields."""
    names = BLOCKS + (("il_in", "il_out") if idx.il_in is not None else ())
    for name in names + WHOLE:
        rec[f"{step}|{name}"] = _np(_leaf(idx, name))
    rec[f"{step}|scheme"] = np.array(repr(idx.scheme))


def _layout(lay) -> list:
    return [lay.kind, lay.axis, lay.shards]


def lifecycle(rec, mesh):
    """run_multidevice.py's GSPMD steps on this rank's blocks."""
    src, dst, u, v, ns, nd, u2, v2 = inputs()
    g = TG.make_graph(src, dst, N, m_cap=M + 64, device="cpu")
    tr = TD.SchemeTraffic()
    rounds = []
    idx = TD.distributed_build(g, mesh, n_cap=N, rounds=rounds, traffic=tr,
                               **KW)
    put_index(rec, "build", idx)
    rec["build|rounds"] = np.array(rounds)
    rec["build|traffic"] = np.array(json.dumps(tr.as_dict()))
    rec["verdicts|v"] = TD.distributed_label_verdicts(idx, mesh, u, v).numpy()
    rec["verdicts|method"] = idx.label_verdicts(u, v).numpy()

    tr, rounds = TD.SchemeTraffic(), []
    idx2 = TD.distributed_insert(idx, mesh, ns, nd, max_iters=64,
                                 rounds=rounds, traffic=tr)
    put_index(rec, "insert", idx2)
    rec["insert|rounds"] = np.array(rounds)
    rec["insert|traffic"] = np.array(json.dumps(tr.as_dict()))
    rec["insert|epoch_type"] = np.array(type(idx2.epoch).__name__)
    want, whole2 = TD.index_shardings(mesh), TD.gather_index(idx2)
    rec["insert|local_shapes"] = np.array(json.dumps({
        name: [list(_leaf(idx2, name).shape),
               list(_leaf(want, name).local_shape(_leaf(whole2,
                                                        name).shape))]
        for name in BLOCKS}))
    rec["insert|scheme_is_mesh"] = np.bool_(idx2.scheme == mesh)
    # the index method runs the same insert
    put_index(rec, "insert_method",
              idx.insert_edges(ns, nd, max_iters=64))
    idx3b = TD.distributed_insert(idx2, mesh, nd[:8], ns[:8], max_iters=64)
    put_index(rec, "second", idx3b)

    idxd = idx2.delete_edges(src[:32], dst[:32])
    put_index(rec, "delete", idxd)
    rec["dirty|ans"] = np.asarray(idxd.query(u2, v2, bfs_chunk=128,
                                             max_iters=64, driver="host"))
    rec["dirty|engine"] = np.asarray(idxd.query(u2, v2, bfs_chunk=128,
                                                max_iters=64))
    idxr = idxd.rebuild(max_iters=64)
    put_index(rec, "rebuild", idxr)
    rec["rebuild|ans"] = np.asarray(idxr.query(u2, v2, bfs_chunk=128,
                                               max_iters=64, driver="host"))

    mesh2 = make_mesh_compat((WORLD,), ("data",), device="cpu") \
        if mesh.size > 1 else make_mesh_compat((1,), ("data",), device="cpu")
    idx3 = TD.shard_index(idx2, mesh2)
    put_index(rec, "replace", idx3)
    rec["replace|v"] = TD.distributed_label_verdicts(idx3, mesh2, u,
                                                     v).numpy()
    # a whole index placed on the new mesh equals the re-placed one
    put_index(rec, "replace_whole",
              TD.shard_index(TD.gather_index(idx2), mesh2))

    eng = TEngine(bfs_chunk=128, max_iters=64, mesh=mesh2)
    placed = reach_place_index(idx2, mesh2)
    rec["engine|ans"] = eng.run(placed, u, v)
    rec["engine|placed_scheme"] = np.bool_(placed.scheme is None)
    rec["layout_of|scheme"] = np.array(_layout(TPL.layout_of(idx)))
    rec["layout_of|replicated"] = np.array(_layout(TPL.layout_of(placed)))
    rec["layout_of|plane"] = np.array(_layout(TPL.layout_of(idx.dl_in)))


def il_insert(rec, mesh):
    """An "il" index built and inserted into in the scheme."""
    src, dst, u, v, ns, nd, _, _ = inputs()
    g = TG.make_graph(src, dst, N, m_cap=M + 64, device="cpu")
    idx = TD.distributed_build(g, mesh, n_cap=N, **KW, **FAM)
    put_index(rec, "il_build", idx)
    idx2 = TD.distributed_insert(idx, mesh, ns, nd, max_iters=64)
    put_index(rec, "il_insert", idx2)
    rec["il_verdicts|v"] = TD.distributed_label_verdicts(idx2, mesh, u,
                                                         v).numpy()


def saturation(rec, mesh):
    """``check`` at a ``max_iters`` the insert does not converge within:
    "raise" raises the reference's message, "warn" warns it, "defer" only
    sets the sticky flag; the planes cut off there equal the
    reference's."""
    src, dst, _, _, ns, nd, _, _ = inputs()
    g = TG.make_graph(src, dst, N, m_cap=M + 64, device="cpu")
    idx = TD.distributed_build(g, mesh, n_cap=N, **KW)
    try:
        TD.distributed_insert(idx, mesh, ns, nd, max_iters=SAT_ITERS,
                              check="raise")
        rec["sat|raised"] = np.array("")
    except LabelSaturationError as e:
        rec["sat|raised"] = np.array(str(e))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        TD.distributed_insert(idx, mesh, ns, nd, max_iters=SAT_ITERS)
        deferred = TD.distributed_insert(idx, mesh, ns, nd,
                                         max_iters=SAT_ITERS, check="defer")
    rec["sat|warned"] = np.array(json.dumps(
        [str(w.message) for w in caught
         if issubclass(w.category, LabelSaturationWarning)]))
    put_index(rec, "sat_defer", deferred)
    try:
        TD.distributed_insert(idx, mesh, ns, nd, check="sometimes")
        rec["sat|bad_check"] = np.array("")
    except ValueError as e:
        rec["sat|bad_check"] = np.array(str(e))


def vertex_layouts(rec, mesh):
    """``vertex_index_shardings`` against the blocks a vertex-sharded
    build holds, and ``layout_of`` a shard."""
    src, dst = inputs()[:2]
    g = TG.make_graph(src, dst, N, m_cap=M + 64, device="cpu")
    ref = TIndex.build(g, n_cap=N, device="cpu", **KW)
    vmesh = TD.vertex_mesh(mesh.size, device="cpu")
    vidx, _ = TD.build_vertex_sharded(g, vmesh, n_cap=N, **KW)
    lays = TD.vertex_index_shardings(vmesh)
    same = {}
    for name in (*PLANES, *(f"packed.{p}" for p in PLANES), "landmarks",
                 "graph.src", "graph.dst", "graph.del_at", "graph.n"):
        same[name] = bool(torch.equal(_leaf(lays, name).shard(
            _leaf(ref, name)), _leaf(vidx, name)))
    rows = vidx.store.rows
    for name in ("bl_sources", "bl_sinks"):
        same[name] = bool(torch.equal(_leaf(lays, name).shard(
            _leaf(ref, name)), _leaf(vidx, name)[rows]))
    rec["vertex|same"] = np.array(json.dumps(same))
    rec["vertex|layout_of"] = np.array(_layout(TPL.layout_of(vidx)))


CASES = {"lifecycle": lifecycle, "il_insert": il_insert,
         "saturation": saturation, "vertex_layouts": vertex_layouts}
#: the cases each world runs, with its mesh shape
WORLDS = ((WORLD, (2, 2), tuple(CASES)), (1, (1, 1), ("lifecycle",)))


def _rank_main(rank, world, shape, store_path, out_dir, names):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        rec = {}
        for name in names:
            CASES[name](rec, mesh)
        np.savez(os.path.join(out_dir, f"w{world}_rank{rank}.npz"), **rec)
    finally:
        dist.destroy_process_group()


def script_main(out_dir):
    for world, shape, names in WORLDS:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world, join=True,
            args=(world, shape, os.path.join(out_dir, f"store{world}"),
                  out_dir, names))


# ------------------------------------------------- the JAX package side
def _spec(sh) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def _specs(tree) -> dict:
    import jax
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)] = _spec(sh)
    return out


def jax_main(out_path):
    """``layout_of`` and the layouts' specs on 4 forced host devices."""
    import jax
    from repro.core import DBLIndex as JIndex
    from repro.core import distributed as JD
    from repro.core import graph as JG
    from repro.core import planes as JPL
    from repro.launch import sharding as JS
    from repro.launch.mesh import make_mesh_compat as jmesh

    assert len(jax.devices()) == WORLD, jax.devices()
    src, dst = inputs()[:2]
    g = JG.make_graph(src, dst, N, m_cap=M + 64)
    ref = JIndex.build(g, n_cap=N, **KW)
    mesh = jmesh((2, 2), ("data", "model"))
    vmesh = JD.vertex_mesh(WORLD)
    vidx, _ = JD.build_vertex_sharded(g, vmesh, n_cap=N, **KW)

    def lay(x):
        lo = JPL.layout_of(x)
        return [lo.kind, lo.axis, lo.shards]
    rec = {"layout_of": {
        "scheme": lay(JD.shard_index(ref, mesh).dl_in),
        "replicated": lay(ref.dl_in),
        "vertex": lay(vidx.dl_in),
        "one": lay(JD.shard_index(ref, jax.sharding.Mesh(
            np.array(jax.devices()[:1]), ("data",))).dl_in)},
        "index": {str(il): _specs(JD.index_shardings(mesh, il=il))
                  for il in (False, True)},
        "vertex": {str(il): _specs(JD.vertex_index_shardings(vmesh, il=il))
                   for il in (False, True)},
        "reach_query": [_spec(s) for s in JS.reach_query_shardings(mesh)],
        "reach_vertex": [_spec(s) for s in JS.reach_vertex_shardings(vmesh)],
        "reach_halo": [_spec(s) for s in JS.reach_halo_shardings(vmesh)]}
    for name in ("reach_vertex_shardings", "reach_halo_shardings"):
        try:
            getattr(JS, name)(mesh)
        except ValueError as e:
            rec[name] = str(e)
    Path(out_path).write_text(json.dumps(rec))


def start_jax(out_dir):
    env = {**os.environ, "PYTHONPATH": f"{Path(__file__).parents[1] / 'src'}"
           f":{Path(__file__).parents[1]}", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    out = os.path.join(out_dir, "jax.json")
    proc = subprocess.Popen([sys.executable, __file__, "--jax", out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _wait(proc, what):
    try:
        so, se = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        so, se = proc.communicate()
        raise AssertionError(f"{what} ran past {RUN_TIMEOUT_S} s:\n{se}")
    assert proc.returncode == 0, so + "\n" + se


# ----------------------------------------------------------- pytest side
def jax_reference() -> dict:
    """Every step on the JAX package's replicated index."""
    import jax.numpy as jnp
    from repro.core import DBLIndex as JIndex
    from repro.core import graph as JG
    from repro.core.dbl import LabelSaturationError as JSatError
    from repro.core.dbl import _saturation_message
    src, dst, u, v, ns, nd, u2, v2 = inputs()
    g = JG.make_graph(src, dst, N, m_cap=M + 64)
    ref = JIndex.build(g, n_cap=N, **KW)
    ref2 = ref.insert_edges(ns, nd, max_iters=64)
    refd = ref2.delete_edges(src[:32], dst[:32])
    refr = refd.rebuild(max_iters=64)
    il = JIndex.build(g, n_cap=N, **KW, **FAM)
    il2 = il.insert_edges(ns, nd, max_iters=64)
    sat = ref.insert_edges(ns, nd, max_iters=SAT_ITERS, check="defer")
    try:
        ref.insert_edges(ns, nd, max_iters=SAT_ITERS, check="raise")
        raised = ""
    except JSatError as e:
        raised = str(e)
    q = dict(bfs_chunk=128, max_iters=64, driver="host")
    return {
        "build": ref, "insert": ref2, "insert_method": ref2,
        "second": ref2.insert_edges(nd[:8], ns[:8], max_iters=64),
        "delete": refd, "rebuild": refr, "replace": ref2,
        "replace_whole": ref2, "il_build": il, "il_insert": il2,
        "sat_defer": sat,
        "verdicts|v": np.asarray(ref.label_verdicts(jnp.asarray(u),
                                                    jnp.asarray(v))),
        "replace|v": np.asarray(ref2.label_verdicts(u, v)),
        "il_verdicts|v": np.asarray(il2.label_verdicts(u, v)),
        "dirty|ans": np.asarray(refd.query(u2, v2, **q)),
        "rebuild|ans": np.asarray(refr.query(u2, v2, **q)),
        "engine|ans": np.asarray(ref2.query(u, v, **q)),
        "sat|raised": raised, "sat|message": _saturation_message(SAT_ITERS)}


@pytest.fixture(scope="module")
def world():
    proc, out_dir = start_world(Path(__file__), [])
    jproc, jout = start_jax(out_dir)
    try:
        ref = jax_reference()
    except BaseException:
        for p in (proc, jproc):
            p.kill()
            p.communicate()
        raise
    _wait(proc, "the gloo ranks")
    _wait(jproc, "the JAX run")
    ranks = {w: [dict(np.load(os.path.join(out_dir, f"w{w}_rank{r}.npz")))
                 for r in range(w)] for w, _, _ in WORLDS}
    return ranks, ref, json.loads(Path(jout).read_text())


def _ref_leaf(ref, name):
    a = np.asarray(_leaf(ref, name))
    return _bits(a) if name.startswith("packed.") else a


def assert_index(ranks, ref, step):
    """Blocks concatenated in rank order equal the reference's leaves bit
    for bit; whole fields equal on every rank and the reference's."""
    names = BLOCKS + (("il_in", "il_out")
                      if f"{step}|il_in" in ranks[0] else ())
    for name in names:
        got = np.concatenate([r[f"{step}|{name}"] for r in ranks])
        if name.startswith("packed."):
            got = _bits(got)
        want = _ref_leaf(ref, name)
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f"{step} {name}")
    for name in WHOLE:
        for r in ranks:
            np.testing.assert_array_equal(r[f"{step}|{name}"],
                                          ranks[0][f"{step}|{name}"],
                                          err_msg=f"{step} {name}")
        np.testing.assert_array_equal(ranks[0][f"{step}|{name}"],
                                      _ref_leaf(ref, name),
                                      err_msg=f"{step} {name}")


def _same(ranks, key):
    for r in ranks:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


INDEX_STEPS = ("build", "insert", "insert_method", "second", "delete",
               "rebuild", "replace", "replace_whole")


@pytest.mark.parametrize("step", INDEX_STEPS)
def test_scheme_index_bitwise(world, step):
    """Build, insert (by ``distributed_insert`` and by the index method),
    the second batch, delete, rebuild and the re-placements from (2, 2)
    to (4,), on 4 ranks."""
    ranks, ref, _ = world
    assert_index(ranks[WORLD], ref[step], step)


@pytest.mark.parametrize("step", INDEX_STEPS)
def test_world_of_one_bitwise(world, step):
    """The same steps in a world of one rank on a (1, 1) mesh."""
    ranks, ref, _ = world
    assert_index(ranks[1], ref[step], step)


@pytest.mark.parametrize("world_size", [WORLD, 1])
@pytest.mark.parametrize("key", ["verdicts|v", "replace|v", "dirty|ans",
                                 "rebuild|ans", "engine|ans"])
def test_answers_bitwise(world, key, world_size):
    """4 096 verdicts on (2, 2) and after the re-placement, the dirty
    query and the query after the rebuild (host driver), and the
    ``QueryEngine`` over a launch mesh after ``reach_place_index``."""
    ranks, ref, _ = world
    got = _same(ranks[world_size], key)
    np.testing.assert_array_equal(got, ref[key], err_msg=key)


def test_label_verdicts_method_and_engine_query_agree(world):
    ranks, ref, _ = world
    rs = ranks[WORLD]
    np.testing.assert_array_equal(_same(rs, "verdicts|method"),
                                  ref["verdicts|v"])
    np.testing.assert_array_equal(_same(rs, "dirty|engine"),
                                  ref["dirty|ans"])
    assert bool(_same(rs, "engine|placed_scheme"))


def test_insert_keeps_the_scheme(world):
    """The insert comes out in ``index_shardings(mesh)``: each leaf is
    the rank's block of the whole shape, the index records the mesh, and
    the epoch is 1 (a host int, as every epoch of the port)."""
    ranks, _, _ = world
    for r in ranks[WORLD]:
        shapes = json.loads(str(r["insert|local_shapes"]))
        for name, (got, want) in shapes.items():
            assert got == want, name
        assert bool(r["insert|scheme_is_mesh"])
        assert int(r["insert|epoch"]) == 1
        assert str(r["insert|epoch_type"]) == "int"
        assert int(r["second|epoch"]) == 2
        assert str(r["second|scheme"]) == str(r["insert|scheme"])


@pytest.mark.parametrize("what", ["build", "insert"])
def test_one_all_reduce_a_round(world, what):
    """Every fixpoint round merges the planes with one ``all_reduce`` of
    the whole plane: the calls are the rounds run, the bytes n_cap x
    (k or k') a round; an insert gathers each of the four planes once."""
    ranks, _, _ = world
    r = ranks[WORLD][0]
    rounds = [min(int(i), KW["max_iters"]) for i in r[f"{what}|rounds"]]
    tr = json.loads(str(r[f"{what}|traffic"]))
    assert tr["all_reduce_calls"] == sum(rounds)
    # dl, dl, bl, bl: k = k' here
    assert tr["all_reduce_bytes"] == sum(rounds) * N * KW["k"]
    if what == "insert":
        assert tr["all_gather_calls"] == 4
        assert tr["all_gather_bytes"] == 4 * (N // WORLD) * KW["k"]
    else:
        assert tr["all_gather_calls"] == 0


@pytest.mark.parametrize("step", ["il_build", "il_insert"])
def test_il_insert_bitwise(world, step):
    ranks, ref, _ = world
    assert_index(ranks[WORLD], ref[step], step)


def test_il_verdicts_bitwise(world):
    ranks, ref, _ = world
    np.testing.assert_array_equal(_same(ranks[WORLD], "il_verdicts|v"),
                                  ref["il_verdicts|v"])


def test_saturation_check_modes(world):
    ranks, ref, _ = world
    rs = ranks[WORLD]
    assert ref["sat|raised"] == ref["sat|message"] != ""
    assert str(_same(rs, "sat|raised")) == ref["sat|raised"]
    assert json.loads(str(_same(rs, "sat|warned"))) == [ref["sat|message"]]
    assert "unknown check mode 'sometimes'" in str(_same(rs, "sat|bad_check"))
    assert_index(rs, ref["sat_defer"], "sat_defer")
    assert bool(rs[0]["sat_defer|saturated"])


def test_vertex_index_shardings_match_the_vertex_blocks(world):
    ranks, _, _ = world
    for r in ranks[WORLD]:
        same = json.loads(str(r["vertex|same"]))
        assert same and all(same.values()), same


def test_layout_of_equals_reference(world):
    """``planes.layout_of`` on a scheme-sharded, a vertex-sharded and a
    replicated index, and on a (1,)-mesh one: the reference's answers."""
    ranks, _, jx = world
    want = jx["layout_of"]
    for r in ranks[WORLD]:
        assert list(r["layout_of|scheme"]) == [str(x) for x in
                                               want["scheme"]]
        assert list(r["vertex|layout_of"]) == [str(x) for x in
                                               want["vertex"]]
        assert list(r["layout_of|replicated"]) == [
            str(x) for x in want["replicated"]]
        assert list(r["layout_of|plane"]) == [str(x) for x in
                                              want["replicated"]]
    assert list(ranks[1][0]["layout_of|scheme"]) == [
        str(x) for x in want["one"]]


# ---------------------------------------------- layouts, in process
def _abstract(shape, axes, coords=None):
    return Mesh(tuple(axes), tuple(shape), coords, torch.device("cpu"))


def _port_specs(tree) -> dict:
    """The port's layout tree as the reference's key paths name it."""
    out = {}
    names = ["graph.src", "graph.dst", "graph.n", "graph.m",
             "graph.del_at", "graph.del_epoch", "landmarks", *PLANES,
             *(f"packed.{p}" for p in PLANES), "bl_sources", "bl_sinks",
             "epoch", "label_del_epoch", "saturated", "il_in", "il_out",
             "il_seed"]
    for name in names:
        lay = _leaf(tree, name)
        if lay is not None:
            out["." + name] = [list(e) if isinstance(e, tuple) else e
                               for e in lay.spec]
    return out


@pytest.mark.parametrize("il", [False, True])
def test_index_shardings_specs_equal_reference(world, il):
    _, _, jx = world
    got = _port_specs(TD.index_shardings(_abstract((2, 2),
                                                   ("data", "model")),
                                         il=il))
    assert got == jx["index"][str(il)]


@pytest.mark.parametrize("il", [False, True])
def test_vertex_index_shardings_specs_equal_reference(world, il):
    _, _, jx = world
    got = _port_specs(TD.vertex_index_shardings(
        _abstract((WORLD,), ("vertex",)), il=il))
    assert got == jx["vertex"][str(il)]


def test_reach_layouts_equal_reference(world):
    _, _, jx = world
    mesh = _abstract((2, 2), ("data", "model"))
    vmesh = _abstract((WORLD,), ("vertex",))

    def specs(lays):
        return [[list(e) if isinstance(e, tuple) else e for e in lay.spec]
                for lay in lays]
    assert specs(reach_query_shardings(mesh)) == jx["reach_query"]
    assert specs(reach_vertex_shardings(vmesh)) == jx["reach_vertex"]
    assert specs(reach_halo_shardings(vmesh)) == jx["reach_halo"]
    for fn in (reach_vertex_shardings, reach_halo_shardings):
        with pytest.raises(ValueError) as e:
            fn(mesh)
        assert str(e.value) == jx[fn.__name__]
    assert reach_query_shardings(mesh)[0].spec == P(("data", "model"))


def test_scheme_refusals():
    """A vertex-sharded index is not re-placed into the scheme, and an
    engine refuses a scheme-sharded index (it serves it placed)."""
    src, dst = power_law(64, 300, seed=4)
    g = TG.make_graph(src, dst, 64, device="cpu")
    idx = TIndex.build(g, n_cap=64, device="cpu", k=8, k_prime=8)
    vmesh = TD.VertexMesh(None, 0, 2, torch.device("cpu"))
    shard = TD.place_vertex_sharded(idx, vmesh)
    with pytest.raises(ValueError, match="vertex-sharded"):
        TD.shard_index(shard, _abstract((2,), ("data",), (0,)))
    with pytest.raises(ValueError, match="vertex_mesh="):
        reach_place_index(shard, _abstract((2,), ("data",), (0,)))
    # a one-rank scheme index, made without a process group
    one = TD.map_index(lambda x: x, idx,
                       scheme=_abstract((1,), ("data",), (0,)))
    with pytest.raises(ValueError, match="reach_place_index"):
        TEngine(one)
    assert one.n_cap == 64 and TPL.layout_of(one) == TPL.REPLICATED


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        jax_main(sys.argv[2])
    else:
        script_main(sys.argv[1])
