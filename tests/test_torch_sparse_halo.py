"""The port's sparse halo exchange (``core/halo.py``, the plans' hub lane,
``halo_mode=``/``hub_count=``/``telemetry=``/``halo_caps=`` through the
lifecycle and the engine) over 4 gloo ranks on the CPU, held bitwise
against the dense exchange and the JAX package.

A twin of ``tests/distributed/run_sparse_halo.py`` on the rank harness of
``tests/test_torch_sharded_planes.py``: the file runs itself as a script
in a subprocess that spawns the ranks, and every rank records its rows,
``iters`` and telemetry per case.  Meanwhile a second subprocess runs the
same halo-level cases on the JAX package over 4 forced host devices
(``--jax``), and pytest replays the lifecycle and the engine stream on
both packages' replicated index and engine.  Then:

- ``halo_level_parity``, ``overflow_fallback_and_caps`` and
  ``degenerate_plans``: sparse rows and ``iters`` equal the dense ones and
  the JAX package's, and both telemetry dicts equal the JAX package's
  ``HaloTelemetry.as_dict()`` on the same inputs;
- ``lifecycle_sparse_differential``: build, inserts reaching fresh rows,
  delete, delta rebuild and an insert after it, with
  ``halo_mode="sparse", hub_count=8``, bool and packed planes, every step
  bitwise equal to both packages' replicated index with equal rounds;
- ``engine_telemetry_stream``: a sparse and a dense sharded engine answer
  as both packages' replicated engines, with equal halo rounds and fewer
  modeled bytes, surfaced by ``halo_stats()`` and the server;
- the reference's ``regime_hlo`` becomes a collective audit: per round of
  each regime, the ``all_to_all_single`` and ``all_reduce`` calls (a
  local round issues no ``all_to_all_single``; no regime gathers).
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import distributed as TD
from repro_torch.core import graph as TG
from repro_torch.core import halo as TH
from repro_torch.core import planes as TPL
from repro_torch.graphs.generators import power_law
from repro_torch.serve.engine import QueryEngine as TEngine
from repro_torch.serve.reach_server import ReachabilityServer
from tests.test_torch_sharded_planes import (ROOT, RUN_TIMEOUT_S, WORLD,
                                             ShardRun, assert_case,
                                             clean_batch, finish_world,
                                             replay, script_main,
                                             start_world)

K = dict(k=16, k_prime=16, max_iters=64)
ENG = dict(bfs_chunk=64, max_iters=64)
INT_MAX = 2 ** 31 - 1
SPARSE = dict(halo_mode="sparse")
TEL_KEYS = ("halo_bytes", "halo_rounds", "dense_rounds", "sparse_rounds",
            "local_rounds", "quiet_pair_rounds", "nonquiet_pair_rounds",
            "fixpoints")


# ------------------------------------------------- halo-level inputs
def graph_edges(name):
    """(n, src, dst, m, m_cap): a power-law graph ("pl<seed>"), every edge
    inside shard 0's rows ("local": no cut edge), or no edge ("empty")."""
    if name.startswith("pl"):
        src, dst = power_law(256, 1400, seed=int(name[2:]))
        return 256, src, dst, 1400, 1464
    rng = np.random.default_rng(12)
    src = rng.integers(0, 16, 80).astype(np.int32)
    dst = rng.integers(0, 16, 80).astype(np.int32)
    if name == "local":
        return 64, src, dst, 80, 128
    return 64, src[:0], dst[:0], 0, 16


#: (k, seed vertices): one per shard region, every second vertex, or
#: a few inside shard 0
SEEDS = {"spread": (20, np.arange(16) * 15), "wide": (16, np.arange(0, 256, 2)),
         "local": (16, np.arange(12))}


def seed_planes(n, seeds_key):
    """A 0/1 uint8 seed plane, the int32 rank plane on the same entries
    (negative ranks: the hub lane's sum must be exact for them) and the
    seed frontier."""
    k, seeds = SEEDS[seeds_key]
    lanes = np.arange(len(seeds)) % k
    plane = np.zeros((n, k), np.uint8)
    plane[seeds, lanes] = 1
    ranks = np.full((n, k), INT_MAX, np.int32)
    ranks[seeds, lanes] = -(np.arange(len(seeds)) + 7)
    frontier = np.zeros(n, bool)
    frontier[seeds] = True
    return plane, ranks, frontier


def halo_entries():
    """(case, graph, seeds, hub_count, caps, monoid, plane_repr, reverse,
    frontier on, max_iters) of every halo-level run; caps "H" is the
    plan's (H, 4H), which the sanitizer drops to none."""
    out = []
    for hub in (0, 8):
        for monoid, repr_ in (("or", "bool"), ("or", "packed"),
                              ("min", "bool")):
            for rev in (False, True):
                out.append(("parity", "pl3", "spread", hub, None, monoid,
                            repr_, rev, True, 64))
        out.append(("zero", "pl3", "spread", hub, None, "or", "bool", False,
                    False, 64))
    out.append(("truncated", "pl3", "spread", 8, None, "or", "packed", True,
                True, 2))
    for hub, caps in ((0, (2, 8)), (8, (2, 8)), (0, "H")):
        out.append(("overflow", "pl5", "wide", hub, caps, "or", "bool", False,
                    True, 64))
    for hub in (0, 4):
        out.append(("local", "local", "local", hub, None, "or", "bool", False,
                    True, 32))
    out.append(("empty", "empty", "local", 4, None, "or", "bool", False, True,
                32))
    return out


def _caps(caps, H):
    return (H, 4 * H) if caps == "H" else caps


# --------------------------------------------------------- rank cases
def halo_level(run):
    """Every entry of :func:`halo_entries` on this rank's rows: dense and
    sparse, each with its own telemetry."""
    mesh = run.mesh
    plans = {}
    for i, (_, gname, skey, hub, caps, monoid, repr_, rev, on, mi) in \
            enumerate(halo_entries()):
        n, src, dst, m, m_cap = graph_edges(gname)
        n_loc = n // WORLD
        rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
        g = TG.make_graph(src, dst, n, m_cap=m_cap, device="cpu")
        if (gname, hub) not in plans:
            plans[(gname, hub)] = TPL.shard_plan(g.src, g.dst, m, n, mesh,
                                                 hub_count=hub)
        plan = plans[(gname, hub)]
        assert plan.hub_count == hub
        plane, ranks, frontier = seed_planes(n, skey)
        x = torch.from_numpy((ranks if monoid == "min" else plane)[rows])
        fr = torch.from_numpy(frontier[rows] & on)
        H = (plan.bwd if rev else plan.fwd).h_send.shape[1]
        for mode, kw in (("dense", {}),
                         ("sparse", dict(halo_mode="sparse",
                                         halo_caps=_caps(caps, H)))):
            tel = TH.HaloTelemetry()
            out, it = TPL.halo_propagate(
                plan, x, fr, TG.edge_mask(g), reverse=rev, max_iters=mi,
                monoid=monoid, plane_repr=repr_, telemetry=tel, **kw)
            run.rec[f"halo|{i}|{mode}|rows"] = out.numpy()
            run.rec[f"halo|{i}|{mode}|iters"] = np.int64(it)
            run.rec[f"halo|{i}|{mode}|tel"] = np.array(
                json.dumps(tel.as_dict()))
    run.rec["halo|local_hubs"] = plans[("local", 4)].fwd.hubs.numpy()
    run.rec["halo|local_valid"] = np.int64(
        plans[("local", 4)].fwd.host.h_valid.sum())


class SparseRun(ShardRun):
    """A lifecycle with every fixpoint on the sparse halo, the plans with
    a hub lane of 8, one telemetry over the whole case."""

    def __init__(self, mesh, rec, case):
        super().__init__(mesh, rec, case)
        self.tel = TH.HaloTelemetry()

    def _put(self, step, idx, plan, rounds, info=None):
        super()._put(step, idx, plan, rounds, info)
        self.rec[f"{self.case}|{step}|hubs"] = np.array(
            [plan.hub_count, plan.fwd.hubs.shape[0], plan.bwd.hubs.shape[0],
             plan.fwd.host.h_send.shape[2]])
        self.rec[f"{self.case}|tel"] = np.array(json.dumps(self.tel.as_dict()))

    def build(self, step, g, **kw):
        super().build(step, g, hub_count=8, telemetry=self.tel, **SPARSE,
                      **kw)

    def insert(self, step, frm, ns, nd, extend=True, **kw):
        super().insert(step, frm, ns, nd, extend, telemetry=self.tel,
                       **SPARSE, **kw)

    def rebuild(self, step, frm, plan_from=None, **kw):
        super().rebuild(step, frm, plan_from, telemetry=self.tel, **SPARSE,
                        **kw)


def _lifecycle(run, repr_):
    """build on edges among [0, 160) -> three inserts reaching fresh rows
    (the plan's halo lists and hub slots extend) -> delete -> delta
    rebuild -> an insert after it."""
    n, m = 256, 1400
    rng = np.random.default_rng(7)
    src = rng.integers(0, 160, m).astype(np.int32)
    dst = rng.integers(0, 160, m).astype(np.int32)
    pr = dict(plane_repr=repr_)
    run.build("build", run.graph(src, dst, n, m + 512), n_cap=n, **pr, **K)
    prev = "build"
    for r in range(3):
        ns = rng.integers(0, n, 32).astype(np.int32)
        nd = rng.integers(0, n, 32).astype(np.int32)
        run.insert(f"insert{r}", prev, ns, nd, max_iters=64, **pr)
        prev = f"insert{r}"
    run.delete("delete", prev, src[10:60], dst[10:60])
    run.rebuild("delta", "delete", mode="delta", max_iters=64, **pr)
    ns = rng.integers(0, n, 16).astype(np.int32)
    nd = rng.integers(0, n, 16).astype(np.int32)
    run.insert("insert_after_delta", "delta", ns, nd, max_iters=64, **pr)


def lifecycle_sparse_bool(run):
    _lifecycle(run, "bool")


def lifecycle_sparse_packed(run):
    _lifecycle(run, "packed")


LIFECYCLES = {f.__name__: f for f in (lifecycle_sparse_bool,
                                      lifecycle_sparse_packed)}


def engine_stream(engines, put):
    """6 rounds of an insert of 24 edges and a query of 96, a delete, the
    auto rebuild and a query, through every engine of ``engines``."""
    n = 256
    src, dst = power_law(n, 1400, seed=9)
    rng = np.random.default_rng(4)
    for r in range(6):
        ns = rng.integers(0, n, 24).astype(np.int32)
        nd = rng.integers(0, n, 24).astype(np.int32)
        u = rng.integers(0, n, 96).astype(np.int32)
        v = rng.integers(0, n, 96).astype(np.int32)
        for name, eng in engines.items():
            eng.insert(ns, nd)
            put(f"{name}|ans{r}", np.asarray(eng.query(u, v)))
    u = rng.integers(0, n, 300).astype(np.int32)
    v = rng.integers(0, n, 300).astype(np.int32)
    for name, eng in engines.items():
        eng.delete(src[:30], dst[:30])
        eng.rebuild(mode="auto")
        put(f"{name}|info", json.dumps(eng.last_rebuild_info, sort_keys=True))
        put(f"{name}|ans_end", np.asarray(eng.query(u, v)))
        put(f"{name}|stats", json.dumps(eng.stats.as_dict(), sort_keys=True))


def engine_index(api_build, api_graph):
    src, dst = power_law(256, 1400, seed=9)
    return api_build(api_graph(src, dst, 256, 1400 + 1024), n_cap=256, **K)


def engine_telemetry_stream(run):
    """A dense and a sparse (hub lane of 8) vertex-sharded engine through
    :func:`engine_stream`; then their halo counts and the server's."""
    idx = engine_index(lambda g, **kw: TIndex.build(g, device="cpu", **kw),
                       lambda *a: TG.make_graph(*a[:3], m_cap=a[3],
                                                device="cpu"))
    engines = {"dense": TEngine(idx, vertex_mesh=run.mesh, **ENG),
               "sparse": TEngine(idx, vertex_mesh=run.mesh, hub_count=8,
                                 **SPARSE, **ENG)}

    def put(key, value):
        run.rec[f"engine|{key}"] = np.asarray(value)
    engine_stream(engines, put)
    for name, eng in engines.items():
        put(f"{name}|halo", json.dumps(eng.halo_stats()))
        put(f"{name}|mirror", json.dumps(eng.stats.as_dict()))
    put("server", json.dumps(ReachabilityServer(
        None, engine=engines["sparse"]).engine_stats(), default=str))


class _Audit:
    """Logs the collectives and marks each round's regime while
    installed; an all-gather or a broadcast raises."""
    COUNTED = ("all_reduce", "all_to_all_single")
    FORBIDDEN = ("all_gather", "all_gather_into_tensor", "all_gather_single",
                 "all_gather_object", "broadcast", "broadcast_object_list",
                 "scatter", "gather")

    def __init__(self):
        self.log, self.saved = [], []

    def _wrap(self, mod, name, fn):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __enter__(self):
        for name in self.COUNTED:
            def call(*a, _f=getattr(dist, name), _n=name, **kw):
                self.log.append(_n)
                return _f(*a, **kw)
            self._wrap(dist, name, call)
        for name in self.FORBIDDEN:
            if hasattr(dist, name):
                def refuse(*a, _n=name, **kw):
                    raise AssertionError(f"{_n} in the sparse halo")
                self._wrap(dist, name, refuse)
        for mod, name, kind in ((TPL, "_dense_exchange", "dense"),
                                (TH, "_sparse_exchange", "sparse"),
                                (TH, "_local_exchange", "local")):
            def mark(*a, _f=getattr(mod, name), _k=kind, **kw):
                self.log.append(("round", _k))
                return _f(*a, **kw)
            self._wrap(mod, name, mark)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)

    def rounds(self):
        """[kind, all_to_all_single, all_reduce] of each round: its calls
        up to the next round's mark (the all_reduce that ends a round is
        its frontier probe)."""
        kinds = ("dense", "sparse", "local")
        out = []
        for ev in self.log:
            if isinstance(ev, tuple):
                out.append([kinds.index(ev[1]), 0, 0])
            elif out:
                out[-1][1 if ev == "all_to_all_single" else 2] += 1
        return out


def collective_audit(run):
    """Sparse fixpoints whose rounds take every regime: a wide frontier
    under tiny caps (dense, then sparse), a spread one with the hub lane,
    and a plan with no cut edge (local only)."""
    mesh = run.mesh
    for tag, gname, skey, hub, caps in (("wide", "pl5", "wide", 0, (2, 8)),
                                        ("hubs", "pl3", "spread", 8, None),
                                        ("local", "local", "local", 0, None)):
        n, src, dst, m, m_cap = graph_edges(gname)
        n_loc = n // WORLD
        rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
        g = TG.make_graph(src, dst, n, m_cap=m_cap, device="cpu")
        plan = TPL.shard_plan(g.src, g.dst, m, n, mesh, hub_count=hub)
        plane, _, frontier = seed_planes(n, skey)
        with _Audit() as audit:
            TPL.halo_propagate(plan, torch.from_numpy(plane[rows]),
                               torch.from_numpy(frontier[rows]),
                               TG.edge_mask(g), max_iters=64,
                               halo_mode="sparse", halo_caps=caps)
        run.rec[f"audit|{tag}"] = np.array(audit.rounds(), np.int64)


def case_runner(mesh, rec, case):
    """The lifecycles run on :class:`SparseRun`; the other cases record
    straight into ``rec`` through a plain :class:`ShardRun`."""
    return (SparseRun if case in LIFECYCLES else ShardRun)(mesh, rec, case)


CASES = {**LIFECYCLES, "halo_level": halo_level,
         "engine_telemetry_stream": engine_telemetry_stream,
         "collective_audit": collective_audit}


# ------------------------------------------------- the JAX package side
def jax_main(out_path):
    """The halo-level entries on the JAX package over 4 forced host
    devices: rows, ``iters`` and both telemetry dicts per entry."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as JD
    from repro.core import graph as JG
    from repro.core import halo as JH
    from repro.core import planes as JPL

    assert len(jax.devices()) == WORLD, jax.devices()
    mesh = JD.vertex_mesh(WORLD)
    plane_sh = JD.vertex_index_shardings(mesh).dl_in
    rec, plans = {}, {}
    for i, (_, gname, skey, hub, caps, monoid, repr_, rev, on, mi) in \
            enumerate(halo_entries()):
        n, src, dst, m, m_cap = graph_edges(gname)
        g = JG.make_graph(src, dst, n, m_cap=m_cap)
        if (gname, hub) not in plans:
            plans[(gname, hub)] = JPL.shard_plan(g.src, g.dst, m, n, mesh,
                                                 hub_count=hub)
        plan = plans[(gname, hub)]
        plane, ranks, frontier = seed_planes(n, skey)
        x = jax.device_put(jnp.asarray(ranks if monoid == "min" else plane),
                           plane_sh)
        fr = jnp.asarray(frontier & on)
        H = (plan.bwd if rev else plan.fwd).h_send.shape[2]
        for mode, kw in (("dense", {}),
                         ("sparse", dict(halo_mode="sparse",
                                         halo_caps=_caps(caps, H)))):
            tel = JH.HaloTelemetry()
            out, it = JPL.halo_propagate(
                plan, x, fr, JG.edge_mask(g), reverse=rev, max_iters=mi,
                monoid=monoid, plane_repr=repr_, telemetry=tel, **kw)
            rec[f"halo|{i}|{mode}|rows"] = np.asarray(out)
            rec[f"halo|{i}|{mode}|iters"] = np.int64(int(it))
            rec[f"halo|{i}|{mode}|tel"] = np.array(json.dumps(tel.as_dict()))
    np.savez(out_path, **rec)


def start_jax(out_dir):
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    out = os.path.join(out_dir, "jax.npz")
    proc = subprocess.Popen([sys.executable, __file__, "--jax", out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def finish_jax(proc, out):
    try:
        so, se = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        so, se = proc.communicate()
        raise AssertionError(f"the JAX run passed {RUN_TIMEOUT_S} s:\n{se}")
    assert proc.returncode == 0, so + "\n" + se
    return dict(np.load(out))


# ----------------------------------------------------------- pytest side
def replay_engines():
    """The engine stream on both packages' replicated engines."""
    from repro.core import DBLIndex as JIndex
    from repro.core import graph as JG
    from repro.serve.engine import QueryEngine as JEngine
    rec = {}
    tidx = engine_index(lambda g, **kw: TIndex.build(g, device="cpu", **kw),
                        lambda *a: TG.make_graph(*a[:3], m_cap=a[3],
                                                 device="cpu"))
    jidx = engine_index(JIndex.build,
                        lambda *a: JG.make_graph(*a[:3], m_cap=a[3]))
    engine_stream({"torch": TEngine(tidx, **ENG), "jax": JEngine(jidx, **ENG)},
                  rec.__setitem__)
    return rec


@pytest.fixture(scope="module")
def world():
    proc, out_dir = start_world(Path(__file__), list(CASES))
    jproc, jout = start_jax(tempfile.mkdtemp(prefix="jax_halo_"))
    try:
        reps = replay(LIFECYCLES, list(LIFECYCLES))
        engines = replay_engines()
    except BaseException:
        for p in (proc, jproc):
            p.kill()
            p.communicate()
        raise
    return finish_world(proc, out_dir), finish_jax(jproc, jout), reps, \
        engines


def _same(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key],
                                      err_msg=f"{key}: ranks disagree")
    return ranks[0][key]


def _tel(a):
    return json.loads(str(a))


ENTRIES = halo_entries()
GROUPS = sorted({e[0] for e in ENTRIES})


@pytest.mark.parametrize("group", GROUPS)
def test_halo_level_bitwise_and_telemetry_equal_reference(world, group):
    """Sparse rows and ``iters`` equal the dense ones and the JAX
    package's; both telemetry dicts equal the JAX package's."""
    ranks, jax_rec, _, _ = world
    seen = 0
    for i, e in enumerate(ENTRIES):
        if e[0] != group:
            continue
        seen += 1
        for mode in ("dense", "sparse"):
            key = f"halo|{i}|{mode}"
            got = np.concatenate([r[key + "|rows"] for r in ranks])
            for want_mode in ("dense", "sparse"):
                want = jax_rec[f"halo|{i}|{want_mode}|rows"]
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{e} {mode} vs JAX {want_mode}")
            assert int(_same(ranks, key + "|iters")) == \
                int(jax_rec[key + "|iters"]), (e, mode)
            assert _tel(_same(ranks, key + "|tel")) == \
                _tel(jax_rec[key + "|tel"]), (e, mode)
        dense = _tel(ranks[0][f"halo|{i}|dense|tel"])
        sparse = _tel(ranks[0][f"halo|{i}|sparse|tel"])
        assert sparse["halo_rounds"] == dense["halo_rounds"], e
        assert sparse["halo_rounds"] == sparse["dense_rounds"] + \
            sparse["sparse_rounds"] + sparse["local_rounds"], e
        if group == "parity":
            assert sparse["halo_bytes"] < dense["halo_bytes"], e
            assert sparse["quiet_pair_rounds"] > 0, e
        if group == "zero":
            assert int(ranks[0][f"halo|{i}|sparse|iters"]) == 0
            assert sparse["halo_bytes"] == 0 and sparse["fixpoints"] == 1
        if group == "truncated":
            assert int(ranks[0][f"halo|{i}|sparse|iters"]) == 3
    assert seen


def _group(group):
    return [(i, e) for i, e in enumerate(ENTRIES) if e[0] == group]


def test_overflow_falls_back_to_dense(world):
    """Tiny caps: the wide early rounds run dense, the tail sparse; with
    the hub lane no round runs dense and fewer bytes move; caps >= H leave
    no sparse shape, so every round is dense."""
    ranks = world[0]
    (i0, _), (i8, _), (ih, _) = _group("overflow")
    d0, d8, dh = (_tel(ranks[0][f"halo|{i}|sparse|tel"])
                  for i in (i0, i8, ih))
    assert d0["dense_rounds"] > 0 and d0["sparse_rounds"] > 0, d0
    assert d8["dense_rounds"] == 0 and d8["sparse_rounds"] > 0, d8
    assert d8["halo_bytes"] < d0["halo_bytes"]
    assert dh["sparse_rounds"] == 0 and dh["dense_rounds"] > 0, dh
    assert TH.bucket_caps(8) == () and TH.bucket_caps(64) == (8, 16)
    # the halo width of the LJ preset at 4 ranks
    assert TH.bucket_caps(960) == (32, 256)


def test_degenerate_plans_run_local_rounds(world):
    """No cut edge: every round local, 4 bytes a rank a round, the hub
    table all padding (``n_cap``, owned by no shard); no edge at all: the
    identity in at most one round."""
    ranks = world[0]
    for i, e in _group("local"):
        d = _tel(ranks[0][f"halo|{i}|sparse|tel"])
        assert d["local_rounds"] == d["halo_rounds"] > 0, (e, d)
        assert d["dense_rounds"] == d["sparse_rounds"] == 0, (e, d)
        assert d["halo_bytes"] == d["halo_rounds"] * WORLD * 4, (e, d)
    assert int(_same(ranks, "halo|local_valid")) == 0
    assert (_same(ranks, "halo|local_hubs") == 64).all()
    (i, _), = _group("empty")
    plane, _, _ = seed_planes(64, "local")
    got = np.concatenate([r[f"halo|{i}|sparse|rows"] for r in ranks])
    np.testing.assert_array_equal(got, plane)
    assert int(ranks[0][f"halo|{i}|sparse|iters"]) in (0, 1)


@pytest.mark.parametrize("ref", ["jax", "torch"])
@pytest.mark.parametrize("case", list(LIFECYCLES))
def test_lifecycle_sparse_bitwise(world, case, ref):
    """Every step's row blocks, words, whole fields, rounds and info equal
    the replicated index's; the hub lane keeps its 8 slots through the
    plan extensions (their remap under a halo spill is held against the
    reference's tables in :func:`test_hub_tables_equal_reference`)."""
    ranks, _, reps, _ = world
    assert_case(ranks, reps[ref], case, f"{case} vs {ref}")
    steps = sorted({k.split("|")[1] for k in ranks[0]
                    if k.startswith(case + "|") and k.endswith("|hubs")})
    hubs = [_same(ranks, f"{case}|{s}|hubs") for s in steps]
    assert len(hubs) == 7 and all(h[:3].tolist() == [8, 8, 8] for h in hubs)
    tel = _tel(_same(ranks, f"{case}|tel"))
    assert tel["sparse_rounds"] > 0 and tel["fixpoints"] > 0, tel
    assert tel["halo_rounds"] == tel["dense_rounds"] + \
        tel["sparse_rounds"] + tel["local_rounds"]


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_engine_stream_answers_equal_replicated(world, ref):
    ranks, _, _, engines = world
    keys = [k.split("|", 1)[1] for k in engines if k.startswith(ref + "|")]
    assert keys
    for name in ("dense", "sparse"):
        for k in keys:
            got = _same(ranks, f"engine|{name}|{k}")
            want = engines[f"{ref}|{k}"]
            if k in ("info", "stats"):
                assert json.loads(str(got)) == json.loads(want), (name, k)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name} {k}")


def test_engine_telemetry_sparse_cheaper_same_rounds(world):
    ranks = world[0]
    sd = _tel(_same(ranks, "engine|dense|halo"))
    ss = _tel(_same(ranks, "engine|sparse|halo"))
    assert ss["fixpoints"] == sd["fixpoints"] > 0, (sd, ss)
    assert ss["halo_rounds"] == sd["halo_rounds"] > 0, (sd, ss)
    assert 0 < ss["halo_bytes"] < sd["halo_bytes"], (sd, ss)
    assert ss["quiet_pair_rounds"] > 0
    assert sd["sparse_rounds"] == 0 and ss["sparse_rounds"] > 0
    mirror = _tel(_same(ranks, "engine|sparse|mirror"))
    for k in ("halo_bytes", "halo_rounds", "quiet_pair_rounds"):
        assert mirror[k] == ss[k], k
    es = _tel(_same(ranks, "engine|server"))
    assert es["halo"]["mode"] == "sparse" and es["halo"]["hub_count"] == 8
    assert es["halo_bytes"] == ss["halo_bytes"]
    assert {k: es["halo"][k] for k in TEL_KEYS} == ss


def test_collective_audit(world):
    """Per round: dense and sparse two ``all_to_all_single`` (positions or
    flags, then rows); sparse with hubs one ``all_reduce`` more (the hub
    lane); every round one ``all_reduce`` (the frontier probe); a local
    round no ``all_to_all_single``.  No rank gathered or broadcast."""
    ranks = world[0]
    kinds = set()
    for tag in ("wide", "hubs", "local"):
        rounds = _same(ranks, f"audit|{tag}")
        assert len(rounds), tag
        for kind, a2a, ar in rounds.tolist():
            kinds.add(kind)
            if kind == 2:
                assert (a2a, ar) == (0, 1), (tag, kind, a2a, ar)
            else:
                hub = kind == 1 and tag == "hubs"
                assert (a2a, ar) == (2, 1 + hub), (tag, kind, a2a, ar)
    assert kinds == {0, 1, 2}


# ------------------------------------------------ in-process checks
def test_bucket_caps_and_regimes_equal_reference():
    from repro.core import halo as JH
    for H in list(range(0, 300)) + [960, 1024, 4097]:
        assert TH.bucket_caps(H) == JH.bucket_caps(H), H
    for caps in ((), (8,), (8, 16), (16, 128)):
        for cmax in (0, 1, 7, 8, 9, 16, 17, 128, 129):
            for hub_any in (False, True):
                got = TH._pick_regime(cmax, hub_any, caps)
                assert got == JH._pick_regime(cmax, hub_any, caps)
                assert TH._fits(got, cmax, hub_any)
    # dense without sparse shapes stays dense through quiet rounds
    assert TH._fits(("dense", 0, 0), 0, False)


def test_telemetry_arithmetic_equals_reference():
    from repro.core import halo as JH
    rng = np.random.default_rng(0)
    t, j = TH.HaloTelemetry(), JH.HaloTelemetry()
    for _ in range(40):
        kind = ("dense", "sparse", "local")[int(rng.integers(3))]
        args = (kind, int(rng.integers(0, 9)), int(rng.integers(0, 65)),
                int(rng.integers(0, 30)), int(rng.integers(0, 30)))
        kw = dict(d=4, H=int(rng.integers(1, 999)),
                  hub_n=int(rng.integers(0, 9)),
                  row_bytes=int(rng.integers(1, 129)))
        t.note_regime(*args, **kw)
        j.note_regime(*args, **kw)
        it, mi = int(rng.integers(0, 10)), 8
        t.add_dense(it, 4096, mi)
        j.add_dense(it, 4096, mi)
    assert t.as_dict() == j.as_dict()


@pytest.mark.parametrize("eg,hg,hub", [(1024, 64, 8), (32, 4, 8),
                                       (32, 4, 3)])
def test_hub_tables_equal_reference(eg, hg, hub):
    """The hub lane's tables (flags, receiver slots, hub ids) built and
    extended over an insert stream that spills the halo: equal to the
    reference's bit for bit; the hub ids never change.  (Imported here:
    the ranks, which import this file, never import JAX.)"""
    from tests.test_torch_plan_extension import (D, assert_host_equal,
                                                 ref_build, ref_extend)
    n, m0 = 256, 900
    src, dst = power_law(n, m0, seed=7)
    n_loc = n // D
    rng = np.random.default_rng(19)
    port = {"f": TPL._build_dir(src, dst, m0, n_loc, D, eg, hg, hub),
            "b": TPL._build_dir(dst, src, m0, n_loc, D, eg, hg, hub)}
    ref = {"f": ref_build(src, dst, m0, n_loc, eg, hg, hub_count=hub),
           "b": ref_build(dst, src, m0, n_loc, eg, hg, hub_count=hub)}
    hubs0 = {k: p.hubs.copy() for k, p in port.items()}
    asrc = src
    for r in range(5):
        ns, nd = clean_batch(rng, n, int(rng.integers(8, 64)))
        s, d, gid, _ = TPL._normalize_batch(ns, nd, len(asrc))
        asrc = np.concatenate([asrc, ns])
        for key, (push, recv) in {"f": (s, d), "b": (d, s)}.items():
            port[key] = TPL._extend_dir(port[key], push, recv, gid, n_loc,
                                        D, eg, hg)
            ref[key] = ref_extend(ref[key], push, recv, gid, n_loc, eg, hg)
            assert_host_equal(port[key], ref[key].host, f"round {r}")
            for f in ("h_hub", "hub_slot", "hubs"):
                np.testing.assert_array_equal(
                    getattr(port[key], f), getattr(ref[key].host, f),
                    err_msg=f"round {r} {key} {f}")
            np.testing.assert_array_equal(port[key].hubs, hubs0[key])
    assert hubs0["f"].size == hub


@pytest.mark.parametrize("kw", [dict(hub_count=-1), dict(halo_caps=()),
                                dict(halo_caps=(8, 0)),
                                dict(halo_mode="ring")])
def test_engine_halo_options_refused_like_the_reference(kw):
    from repro.serve.engine import QueryEngine as JEngine
    with pytest.raises(ValueError) as want:
        JEngine(None, **kw)
    with pytest.raises(ValueError) as got:
        TEngine(None, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_sparse_halo_refuses_bad_monoids():
    plan = TPL.shard_plan(*power_law(64, 200, seed=1), 200, 64,
                          TD.VertexMesh(None, 0, WORLD, torch.device("cpu")))
    x = torch.zeros((16, 8), dtype=torch.uint8)
    fr = torch.zeros(16, dtype=torch.bool)
    live = torch.ones(200, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown monoid"):
        TH.sparse_halo_propagate(plan, x, fr, live, monoid="max")
    with pytest.raises(ValueError, match="OR monoid only"):
        TH.sparse_halo_propagate(plan, x.int(), fr, live, monoid="min",
                                 plane_repr="packed")
    with pytest.raises(ValueError, match="OR monoid only"):
        TPL.halo_propagate(plan, x.int(), fr, live, monoid="min",
                           plane_repr="packed", halo_mode="sparse")


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        jax_main(sys.argv[2])
    else:
        script_main(sys.argv[1:], CASES, case_runner)
