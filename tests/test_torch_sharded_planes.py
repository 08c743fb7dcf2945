"""The port's vertex-sharded layout over 4 gloo ranks on the CPU, held
bitwise against the JAX package's replicated index and the port's.

The file is also the script that runs the ranks.  Pytest starts
``python tests/test_torch_sharded_planes.py <out_dir> <case>...`` in a
subprocess; the script spawns 4 processes (``torch.multiprocessing``,
one gloo rank each over a ``FileStore``, one thread each, a 120 s group
timeout), and every rank runs the lifecycle of each case on its shard and
writes its row blocks, ``iters`` and ``info`` dicts per step to
``<out_dir>/rank<r>.npz``.  Meanwhile the pytest process runs the same
lifecycle on the JAX package's ``DBLIndex`` and the port's replicated one;
then it concatenates the row blocks and compares every step.  A rank that
fails takes the others down (``spawn`` terminates them) and the
subprocess runs under a timeout, so a failure fails and never hangs.

The cases are twins of ``tests/distributed/run_sharded_planes.py``'s
``lifecycle_differential``, ``scc_merge_split_cascade``,
``degenerate_halo_or_noop`` and ``packed_sharded_parity`` and
``run_plan_extension.py``'s ``lifecycle_labels_bitwise`` and
``catchup_window_reinsert``, without their engine and query steps, which
``tests/test_torch_sharded_engine.py`` twins on this harness.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import DBLIndex as TIndex
from repro_torch.core import distributed as TD
from repro_torch.core import graph as TG
from repro_torch.core import interval as TIL
from repro_torch.core import labels as TL
from repro_torch.core import planes as TPL
from repro_torch.core import propagate as TP
from repro_torch.core import update as TU
from repro_torch.graphs.generators import power_law

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
K = dict(k=16, k_prime=16, max_iters=64)
#: the process group's timeout in every rank, and the whole run's
GROUP_TIMEOUT_S = 120
RUN_TIMEOUT_S = 300
ROW_FIELDS = ("dl_in", "dl_out", "bl_in", "bl_out", "il_in", "il_out",
              "packed.dl_in", "packed.dl_out", "packed.bl_in",
              "packed.bl_out")
WHOLE_FIELDS = ("landmarks", "bl_sources", "bl_sinks", "saturated", "m",
                "epoch", "label_del_epoch", "rounds")


# ------------------------------------------------------------ the cases
def clean_batch(rng, n, b):
    """A random batch with no self-loops and no in-batch duplicates."""
    ns = rng.integers(0, n, b).astype(np.int32)
    nd = ((ns + rng.integers(1, n, b)) % n).astype(np.int32)
    seen, keep = set(), np.ones(b, bool)
    for i, pair in enumerate(zip(ns.tolist(), nd.tolist())):
        if pair in seen:
            keep[i] = False
        seen.add(pair)
    return ns[keep], nd[keep]


def lifecycle_differential(run):
    """build -> 3 inserts -> delete -> delta and full rebuild -> insert
    after the delta rebuild."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=3)
    run.build("build", run.graph(src, dst, n, m + 512), n_cap=n, **K)
    rng = np.random.default_rng(0)
    prev = "build"
    for r in range(3):
        ns = rng.integers(0, n, 32).astype(np.int32)
        nd = rng.integers(0, n, 32).astype(np.int32)
        run.insert(f"insert{r}", prev, ns, nd, max_iters=64)
        prev = f"insert{r}"
    run.delete("delete", prev, src[10:60], dst[10:60])
    # the reference's dirty query batch (served in
    # test_torch_sharded_engine.py), drawn so the later insert gets the
    # reference's edges
    rng.integers(0, n, 600), rng.integers(0, n, 600)
    run.rebuild("delta", "delete", mode="delta", max_iters=64)
    run.rebuild("full", "delete", mode="full", max_iters=64)
    ns = rng.integers(0, n, 16).astype(np.int32)
    nd = rng.integers(0, n, 16).astype(np.int32)
    run.insert("insert_after_delta", "delta", ns, nd, max_iters=64)


def scc_merge_split_cascade(run):
    """A chain closed into one SCC spanning all four shards by a back
    edge, then split by a delete and a delta rebuild."""
    n = 64
    chain = np.arange(n - 1, dtype=np.int32)
    run.build("build", run.graph(chain, chain + 1, n, 2 * n + 64), n_cap=n,
              **K)
    back = (np.array([n - 1], np.int32), np.array([0], np.int32))
    run.insert("merge", "build", *back, max_iters=128)
    mid = (np.array([n // 2], np.int32), np.array([n // 2 + 1], np.int32))
    run.delete("delete", "merge", *mid)
    run.rebuild("split", "delete", mode="delta", max_iters=128)


def packed_sharded_parity(run):
    """The word-plane halo fixpoints through build, inserts, delete and
    a delta rebuild."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=6)
    run.build("build", run.graph(src, dst, n, m + 512), n_cap=n,
              plane_repr="packed", **K)
    rng = np.random.default_rng(2)
    prev = "build"
    for r in range(2):
        ns = rng.integers(0, n, 32).astype(np.int32)
        nd = rng.integers(0, n, 32).astype(np.int32)
        run.insert(f"insert{r}", prev, ns, nd, max_iters=64,
                   plane_repr="packed")
        prev = f"insert{r}"
    run.delete("delete", prev, src[5:45], dst[5:45])
    run.rebuild("delta", "delete", mode="delta", max_iters=64,
                plane_repr="packed")


def lifecycle_labels_bitwise(run):
    """Extended plans against from-scratch ones (``extend=False``) over an
    insert stream with a hostile batch (duplicates, self-loops), a delete,
    a delta rebuild, an insert extending its plan, a full rebuild, and a
    delta rebuild handed a plan that misses the last insert (catch-up)."""
    n, m = 256, 1400
    src, dst = power_law(n, m, seed=5)
    rng = np.random.default_rng(21)
    g = run.graph(src, dst, n, m + 1024)
    run.build("build_e", g, n_cap=n, **K)
    run.build("build_s", g, n_cap=n, **K)
    batches = [clean_batch(rng, n, 48) for _ in range(3)]
    batches.insert(2, (np.array([7, 7, 7, 200, 13, 13], np.int32),
                       np.array([190, 190, 190, 200, 77, 77], np.int32)))
    pe, ps = "build_e", "build_s"
    for r, (ns, nd) in enumerate(batches):
        run.insert(f"insert_e{r}", pe, ns, nd, max_iters=64)
        run.insert(f"insert_s{r}", ps, ns, nd, max_iters=64, extend=False)
        pe, ps = f"insert_e{r}", f"insert_s{r}"
    run.delete("delete", pe, src[20:70], dst[20:70])
    run.rebuild("delta", "delete", mode="delta", max_iters=64)
    ns, nd = clean_batch(rng, n, 24)
    run.insert("insert_after_delta", "delta", ns, nd, max_iters=64)
    run.rebuild("full", "insert_after_delta", mode="full", max_iters=64)
    run.build("build2", g, n_cap=n, **K)
    ns, nd = clean_batch(rng, n, 32)
    run.insert("insert2", "build2", ns, nd, max_iters=64)
    run.delete("delete2", "insert2", src[:10], dst[:10])
    run.rebuild("delta_stale_plan", "delete2", mode="delta", max_iters=64,
                plan_from="build2")


def catchup_window_reinsert(run):
    """A pair inserted, deleted and re-inserted inside the window a stale
    plan missed: the delta rebuild's catch-up must route the live slot."""
    n, m = 256, 1200
    src, dst = power_law(n, m, seed=29)
    rng = np.random.default_rng(31)
    a, b = 3, n - 5
    keep = ~((src == a) & (dst == b))
    src, dst = src[keep], dst[keep]
    run.build("build", run.graph(src, dst, n, len(src) + 1024), n_cap=n,
              **K)
    ns1, nd1 = clean_batch(rng, n, 16)
    keep = ~((ns1 == a) & (nd1 == b))
    ns1 = np.concatenate([ns1[keep], [a]]).astype(np.int32)
    nd1 = np.concatenate([nd1[keep], [b]]).astype(np.int32)
    run.insert("insert1", "build", ns1, nd1, max_iters=64)
    pair = (np.array([a], np.int32), np.array([b], np.int32))
    run.delete("delete", "insert1", *pair)
    run.insert("reinsert", "delete", *pair, max_iters=64)
    run.rebuild("delta", "reinsert", mode="delta", max_iters=64,
                plan_from="build")


DEGENERATE_K = 20                 # not a multiple of 32: pad bits


def _degenerate_graphs():
    """(what, src, dst, m) with every edge inside shard 0's rows: no cut
    edge, and the empty edge set."""
    rng = np.random.default_rng(12)
    src = rng.integers(0, 16, 80).astype(np.int32)
    dst = rng.integers(0, 16, 80).astype(np.int32)
    return (("local-only", src, dst, len(src)), ("empty", src, dst, 0))


def _degenerate_seeds(n):
    seeds = np.arange(min(DEGENERATE_K, 16))
    plane = np.zeros((n, DEGENERATE_K), np.uint8)
    plane[seeds, seeds % DEGENERATE_K] = 1
    frontier = np.zeros(n, bool)
    frontier[seeds] = True
    return plane, frontier


def degenerate_halo_or_noop(run):
    """The halo fixpoint on plans with a fabricated, all-invalid halo row
    (no cut edge; no edge at all) is a no-op exchange: bool and packed
    equal the replicated fixpoint.  Runs in the ranks only; pytest holds
    the rows against both packages' ``propagate``."""
    n = 64
    mesh = run.mesh
    n_loc = n // WORLD
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    plane, frontier = _degenerate_seeds(n)
    for what, src, dst, m in _degenerate_graphs():
        g = TG.make_graph(src[:m], dst[:m], n, m_cap=128, device="cpu")
        plan = TPL.shard_plan(g.src, g.dst, m, n, mesh)
        for repr_ in ("bool", "packed"):
            got, it = TPL.halo_propagate(
                plan, torch.from_numpy(plane[rows]),
                torch.from_numpy(frontier[rows]), TG.edge_mask(g),
                max_iters=32, plane_repr=repr_)
            run.rec[f"{run.case}|{what}|{repr_}|rows"] = got.numpy()
            run.rec[f"{run.case}|{what}|{repr_}|iters"] = np.int64(it)


CASES = {f.__name__: f for f in (
    lifecycle_differential, scc_merge_split_cascade, packed_sharded_parity,
    lifecycle_labels_bitwise, catchup_window_reinsert,
    degenerate_halo_or_noop)}
LIFECYCLES = [name for name in CASES if name != "degenerate_halo_or_noop"]


# ------------------------------------------------------------- runners
def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class ShardRun:
    """Runs a case on this rank's shard and records its rows per step."""

    def __init__(self, mesh, rec, case):
        self.mesh, self.rec, self.case = mesh, rec, case
        self.st = {}

    def graph(self, src, dst, n, m_cap):
        return TG.make_graph(src, dst, n, m_cap=m_cap, device="cpu")

    def _put(self, step, idx, plan, rounds, info=None):
        self.st[step] = (idx, plan)
        out = {f: getattr(idx, f) for f in ("dl_in", "dl_out", "bl_in",
                                            "bl_out", "il_in", "il_out",
                                            "landmarks", "bl_sources",
                                            "bl_sinks")}
        out.update({f"packed.{f}": getattr(idx.packed, f)
                    for f in ("dl_in", "dl_out", "bl_in", "bl_out")})
        out.update(saturated=idx.saturated, m=idx.graph.m, epoch=idx.epoch,
                   label_del_epoch=idx.label_del_epoch, rounds=rounds,
                   plan_m=plan.m, bytes=TPL.per_device_label_bytes(idx),
                   info=json.dumps(info, sort_keys=True))
        for f, v in out.items():
            if v is not None:
                self.rec[f"{self.case}|{step}|{f}"] = np.asarray(_np(v))

    def build(self, step, g, **kw):
        rounds = []
        idx, plan = TD.build_vertex_sharded(g, self.mesh, rounds=rounds,
                                            **kw)
        assert idx.layout == TPL.vertex_layout(self.mesh)
        self._put(step, idx, plan, rounds)

    def insert(self, step, frm, ns, nd, extend=True, **kw):
        idx, plan = self.st[frm]
        rounds = []
        idx, plan, _ = TD.insert_vertex_sharded(idx, plan, ns, nd,
                                                extend=extend,
                                                rounds=rounds, **kw)
        self._put(step, idx, plan, rounds)

    def delete(self, step, frm, ds, dd):
        idx, plan = self.st[frm]
        self._put(step, idx.delete_edges(ds, dd), plan, [])

    def rebuild(self, step, frm, plan_from=None, **kw):
        idx, plan = self.st[frm]
        if plan_from is not None:
            plan = self.st[plan_from][1]
        rounds = []
        idx, plan, info = TD.rebuild_vertex_sharded(idx, plan,
                                                    rounds=rounds, **kw)
        self._put(step, idx, plan, rounds, info)


class ReplicaRun:
    """Runs a case on a replicated index of one package (``api``) and
    records whole planes and the fixpoints' rounds per step, the fused
    direction's rounds being the larger of its DL and BL fixpoints'."""

    def __init__(self, api):
        self.api, self.rec, self.st = api, {}, {}
        self.case = None

    def graph(self, src, dst, n, m_cap):
        return self.api.make_graph(src, dst, n, m_cap)

    def _put(self, step, idx, rounds, info=None):
        self.st[step] = idx
        a = self.api
        out = {f: getattr(idx, f) for f in ("dl_in", "dl_out", "bl_in",
                                            "bl_out", "il_in", "il_out",
                                            "landmarks", "bl_sources",
                                            "bl_sinks")}
        out.update({f"packed.{f}": getattr(idx.packed, f)
                    for f in ("dl_in", "dl_out", "bl_in", "bl_out")})
        out.update(saturated=idx.saturated, m=idx.graph.m, epoch=idx.epoch,
                   label_del_epoch=idx.label_del_epoch, rounds=rounds,
                   bytes=a.label_bytes(idx), info=info)
        for f, v in out.items():
            if v is not None:
                self.rec[f"{self.case}|{step}|{f}"] = \
                    v if f == "info" else np.asarray(_np(v))

    def _build_rounds(self, idx, max_iters):
        a, g, n = self.api, idx.graph, idx.n_cap
        dl = a.L.build_dl(g, idx.landmarks, n_cap=n, k=idx.k,
                          max_iters=max_iters)[2]
        bl = a.L.build_bl(g, idx.bl_sources, idx.bl_sinks, n_cap=n,
                          k_prime=idx.k_prime, max_iters=max_iters)[2]
        rounds = [max(int(dl[0]), int(bl[0])), max(int(dl[1]), int(bl[1]))]
        if idx.il_in is not None:
            il = a.IL.build_il(g, n_cap=n, dim=idx.il_dim, seed=idx.il_seed,
                               max_iters=max_iters)[2]
            rounds += [int(il[0]), int(il[1])]
        return rounds

    def build(self, step, g, **kw):
        idx = self.api.build(g, **kw)
        self._put(step, idx, self._build_rounds(idx, kw["max_iters"]))

    def insert(self, step, frm, ns, nd, extend=True, **kw):
        a, prev = self.api, self.st[frm]
        idx = prev.insert_edges(ns, nd, **kw)
        mi = kw["max_iters"]
        it = a.U.insert_and_update(prev.graph, prev.dl_in, prev.dl_out,
                                   prev.bl_in, prev.bl_out, a.ids(ns),
                                   a.ids(nd), prev.epoch, n_cap=prev.n_cap,
                                   max_iters=mi)[5]
        rounds = [max(int(it[0]), int(it[2])), max(int(it[1]), int(it[3]))]
        if prev.il_in is not None:
            il = a.IL.insert_update_il(idx.graph, prev.il_in, prev.il_out,
                                       a.ids(ns), a.ids(nd),
                                       n_cap=prev.n_cap, max_iters=mi)[2]
            rounds += [int(il[0]), int(il[1])]
        self._put(step, idx, rounds)

    def delete(self, step, frm, ds, dd):
        self._put(step, self.st[frm].delete_edges(ds, dd), [])

    def rebuild(self, step, frm, plan_from=None, **kw):
        a, prev = self.api, self.st[frm]
        idx, info = prev.rebuild_info(**kw)
        mi = kw["max_iters"]
        if info["mode"] == "full":
            rounds = self._build_rounds(idx, mi)
        else:
            # the fused fixpoints of the delta repair over the whole live
            # edge set, with the churned lanes' seed rows on the frontier
            dp = prev._delta_plan(selection="product", leaf_r=0)
            g = prev.graph
            st = a.L.delta_plane_state(
                g, prev.dl_in, prev.dl_out, prev.bl_in, prev.bl_out,
                prev.landmarks, dp["landmarks"], prev.bl_sources,
                prev.bl_sinks, dp["sources"], dp["sinks"],
                dp[a.dirty_keys[0]], dp[a.dirty_keys[1]], n_cap=prev.n_cap,
                k=prev.k, k_prime=prev.k_prime)
            live = a.G.edge_mask(g)
            rounds = []
            for rev, x, fresh, seed, fr in ((False, st[0], st[2], st[4],
                                             st[6]),
                                            (True, st[1], st[3], st[5],
                                             st[7])):
                fr = fr | (seed & fresh[None, :]).any(1)
                rounds.append(int(a.P.propagate(
                    x, g.src, g.dst, live, fr, n_cap=prev.n_cap,
                    max_iters=mi, reverse=rev)[1]))
            if idx.il_in is not None:
                il = a.IL.build_il(idx.graph, n_cap=idx.n_cap,
                                   dim=idx.il_dim, seed=idx.il_seed,
                                   max_iters=mi)[2]
                rounds += [int(il[0]), int(il[1])]
        self._put(step, idx, rounds, info)


class TorchAPI:
    """The port's replicated index on the CPU."""
    G, L, P, U, IL = TG, TL, TP, TU, TIL
    dirty_keys = ("dirty_fwd", "dirty_bwd")

    @staticmethod
    def make_graph(src, dst, n, m_cap):
        return TG.make_graph(src, dst, n, m_cap=m_cap, device="cpu")

    @staticmethod
    def build(g, **kw):
        return TIndex.build(g, device="cpu", **kw)

    @staticmethod
    def ids(x):
        return torch.from_numpy(np.asarray(x, np.int32))

    label_bytes = staticmethod(TPL.per_device_label_bytes)


def jax_api():
    """The JAX package's replicated index (imported here: the ranks never
    import JAX)."""
    import jax.numpy as jnp
    from repro.core import DBLIndex as JIndex
    from repro.core import graph as JG
    from repro.core import interval as JIL
    from repro.core import labels as JL
    from repro.core import planes as JPL
    from repro.core import propagate as JP
    from repro.core import update as JU

    class JaxAPI:
        G, L, P, U, IL = JG, JL, JP, JU, JIL
        dirty_keys = ("dirty_fwd_j", "dirty_bwd_j")

        @staticmethod
        def make_graph(src, dst, n, m_cap):
            return JG.make_graph(src, dst, n, m_cap=m_cap)

        @staticmethod
        def build(g, **kw):
            return JIndex.build(g, **kw)

        @staticmethod
        def ids(x):
            return jnp.asarray(np.asarray(x, np.int32))

        label_bytes = staticmethod(JPL.per_device_label_bytes)

    return JaxAPI


# ------------------------------------------------------ the rank script
def _rank_main(rank, world, store_path, out_dir, cases, runner=None):
    """One gloo rank: the cases on this rank's shard, each given a
    ``runner(mesh, rec, case)`` (default :class:`ShardRun`)."""
    runner = runner or ShardRun
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        rec = {}
        if not torch.cuda.is_available():
            # the mesh's device defaults to CUDA and never falls back
            try:
                TD.vertex_mesh()
                raised = False
            except RuntimeError as e:
                raised = "device='cpu'" in str(e)
            rec["mesh|cuda_default_raises"] = np.bool_(raised)
        mesh = TD.vertex_mesh(WORLD, device="cpu")
        for name, fn in cases:
            fn(runner(mesh, rec, name))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **rec)
    finally:
        dist.destroy_process_group()


def fail_on_rank_2(run):
    """A rank that dies before a collective the others are waiting in."""
    if run.mesh.rank == 2:
        raise RuntimeError("rank 2 fails on purpose")
    dist.barrier()


def script_main(argv, cases, runner=None):
    """``<out_dir> <case>...``: spawn the ranks and run the cases."""
    out_dir, names = argv[0], argv[1:]
    torch.multiprocessing.spawn(
        _rank_main, nprocs=WORLD, join=True,
        args=(WORLD, os.path.join(out_dir, "store"), out_dir,
              [(name, cases[name]) for name in names], runner))


# ----------------------------------------------------------- pytest side
def start_world(script: Path, names) -> tuple[subprocess.Popen, str]:
    out_dir = tempfile.mkdtemp(prefix="gloo_world_")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(script), out_dir, *names],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out_dir


def finish_world(proc, out_dir, timeout=RUN_TIMEOUT_S) -> list[dict]:
    """Wait for the ranks (killing them at ``timeout``); their records."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the gloo ranks ran past {timeout} s:\n{err}")
    assert proc.returncode == 0, out + "\n" + err
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(WORLD)]


def replay(cases, names):
    """Each case's records on the JAX package and on the port."""
    reps = {}
    for key, api in (("jax", jax_api()), ("torch", TorchAPI)):
        run = ReplicaRun(api)
        for name in names:
            run.case = name
            cases[name](run)
        reps[key] = run.rec
    return reps


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_case(ranks, rep, case, what):
    """Every recorded step of ``case``: row blocks concatenated in rank
    order equal the replicated planes, words and interval planes bit for
    bit; whole fields, rounds and info dicts equal on every rank and equal
    the replicated ones; per-device bytes times the world equal the
    replicated bytes."""
    steps = sorted({k.split("|")[1] for k in rep
                    if k.startswith(case + "|")})
    assert steps, case
    for step in steps:
        def key(f):
            return f"{case}|{step}|{f}"
        for f in ROW_FIELDS:
            if key(f) not in rep:
                assert key(f) not in ranks[0], (what, step, f)
                continue
            got = np.concatenate([r[key(f)] for r in ranks])
            want = np.asarray(rep[key(f)])
            if f.startswith("packed."):
                got, want = _bits(got), _bits(want)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{what} {step} {f}")
        for f in WHOLE_FIELDS:
            for r in ranks:
                np.testing.assert_array_equal(
                    r[key(f)], ranks[0][key(f)],
                    err_msg=f"{what} {step} {f}: ranks disagree")
            np.testing.assert_array_equal(ranks[0][key(f)], rep[key(f)],
                                          err_msg=f"{what} {step} {f}")
        info = [json.loads(str(r[key("info")])) for r in ranks]
        assert all(i == info[0] for i in info), (what, step)
        assert info[0] == rep.get(key("info")), (what, step)
        for r in ranks:
            assert int(r[key("bytes")]) * WORLD == int(rep[key("bytes")])
        assert int(ranks[0][key("plan_m")]) == int(ranks[0][key("m")])


@pytest.fixture(scope="module")
def world():
    names = list(CASES)
    proc, out_dir = start_world(Path(__file__), names)
    try:
        reps = replay(CASES, LIFECYCLES)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return finish_world(proc, out_dir), reps


@pytest.mark.parametrize("ref", ["jax", "torch"])
@pytest.mark.parametrize("case", LIFECYCLES)
def test_sharded_lifecycle_bitwise(world, case, ref):
    ranks, reps = world
    assert_case(ranks, reps[ref], case, f"{case} vs {ref}")


@pytest.mark.parametrize("ref", ["jax", "torch"])
def test_degenerate_halo_is_a_no_op(world, ref):
    ranks, _ = world
    n = 64
    plane, frontier = _degenerate_seeds(n)
    if ref == "jax":
        import jax.numpy as jnp
        from repro.core import graph as JG
        from repro.core import propagate as JP
    for what, src, dst, m in _degenerate_graphs():
        if ref == "jax":
            g = JG.make_graph(src[:m], dst[:m], n, m_cap=128)
            want, it = JP.propagate(jnp.asarray(plane), g.src, g.dst,
                                    JG.edge_mask(g), jnp.asarray(frontier),
                                    n_cap=n, max_iters=32)
        else:
            g = TG.make_graph(src[:m], dst[:m], n, m_cap=128, device="cpu")
            want, it = TP.propagate(torch.from_numpy(plane), g.src, g.dst,
                                    TG.edge_mask(g),
                                    torch.from_numpy(frontier), n_cap=n,
                                    max_iters=32)
        for repr_ in ("bool", "packed"):
            key = f"degenerate_halo_or_noop|{what}|{repr_}"
            got = np.concatenate([r[key + "|rows"] for r in ranks])
            np.testing.assert_array_equal(got, _np(want),
                                          err_msg=f"{what} {repr_}")
            assert {int(r[key + "|iters"]) for r in ranks} == {int(it)}


def test_mesh_device_defaults_to_cuda(world):
    ranks, _ = world
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    assert all(bool(r["mesh|cuda_default_raises"]) for r in ranks)


def test_vertex_mesh_needs_a_process_group(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        TD.vertex_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        TD.vertex_mesh()


def test_failing_rank_fails_the_run_quickly():
    t = time.perf_counter()
    proc, out_dir = start_world(Path(__file__), ["fail_on_rank_2"])
    out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    assert proc.returncode != 0
    # whichever rank's exit the launcher sees first is reported: rank 2's
    # own error, or a peer's error on the closed connection
    assert "rank 2 fails on purpose" in err or "gloo" in err.lower(), err
    assert time.perf_counter() - t < GROUP_TIMEOUT_S


def _fake_mesh(rank):
    """A mesh handle for code that runs no collective (placement, plans)."""
    return TD.VertexMesh(None, rank, WORLD, torch.device("cpu"))


def test_placed_shards_are_row_blocks_and_refuse_whole_plane_methods():
    n, m = 64, 300
    src, dst = power_law(n, m, seed=4)
    idx = TIndex.build(TG.make_graph(src, dst, n, device="cpu"), n_cap=n,
                       device="cpu", families=("dl", "bl", "il"), **K)
    shards = [TD.place_vertex_sharded(idx, _fake_mesh(r))
              for r in range(WORLD)]
    for f in ("dl_in", "dl_out", "bl_in", "bl_out", "il_in", "il_out"):
        assert torch.equal(torch.cat([getattr(s, f) for s in shards]),
                           getattr(idx, f)), f
    for f in ("dl_in", "dl_out", "bl_in", "bl_out"):
        assert torch.equal(torch.cat([getattr(s.packed, f)
                                      for s in shards]),
                           getattr(idx.packed, f)), f
    s = shards[1]
    assert s.layout == TPL.PlaneLayout("vertex_sharded", "vertex", WORLD, 1)
    assert s.n_cap == n and s.store.n_cap == n
    assert torch.equal(s.bl_sources, idx.bl_sources)
    assert TPL.per_device_label_bytes(s) * WORLD == \
        TPL.per_device_label_bytes(idx)
    assert s.store.label_bytes() == idx.store.label_bytes()
    assert s.store.rows == slice(16, 32)
    # a shard's queries go through the sharded engine; whole-plane reads
    # stay refused by design
    for call in (lambda: s.query([0], [1], driver="host"),
                 lambda: s.label_verdicts([0], [1])):
        with pytest.raises(ValueError, match=r"QueryEngine\(index, "
                                             r"vertex_mesh=mesh\)"):
            call()
    for call in (s.density, s.to_numpy):
        with pytest.raises(ValueError, match="never gathers"):
            call()
    with pytest.raises(ValueError, match="insert_vertex_sharded"):
        s.insert_edges([0], [1])
    with pytest.raises(ValueError, match="rebuild_vertex_sharded"):
        s.rebuild_info(mode="full")
    from repro_torch.serve.engine import QueryEngine
    with pytest.raises(ValueError, match="vertex_mesh="):
        QueryEngine(s)
    # a delete touches only the replicated graph and keeps the layout
    d = s.delete_edges(src[:5], dst[:5])
    assert d.layout == s.layout and d.is_dirty and bool(d.dirty_flag)
    with pytest.raises(ValueError, match="sharded already"):
        TD.place_vertex_sharded(s, _fake_mesh(1))


def test_seed_rows_of_a_shard_equal_the_replicated_seeds():
    n, m = 64, 300
    src, dst = power_law(n, m, seed=8)
    g = TG.make_graph(src, dst, n, device="cpu")
    idx = TIndex.build(g, n_cap=n, device="cpu", **K)
    whole = TPL.PlaneStore.seeds(idx.landmarks, idx.bl_sources,
                                 idx.bl_sinks, n_cap=n, k=16, k_prime=16)
    fr_whole = whole.seed_frontiers()
    for r in range(WORLD):
        lay = TPL.vertex_layout(_fake_mesh(r))
        part = TPL.PlaneStore.seeds(idx.landmarks, idx.bl_sources,
                                    idx.bl_sinks, n_cap=n, k=16,
                                    k_prime=16, layout=lay)
        rows = slice(r * 16, (r + 1) * 16)
        for f in ("dl_in", "dl_out", "bl_in", "bl_out"):
            assert torch.equal(getattr(part, f), getattr(whole, f)[rows])
        for a, b in zip(part.seed_frontiers(), fr_whole):
            assert torch.equal(a, b[rows])
    with pytest.raises(ValueError, match="divide evenly"):
        TPL.PlaneStore.seeds(idx.landmarks, idx.bl_sources, idx.bl_sinks,
                             n_cap=n + 2, k=16, k_prime=16,
                             layout=TPL.vertex_layout(_fake_mesh(0)))


if __name__ == "__main__":
    script_main(sys.argv[1:], {**CASES, "fail_on_rank_2": fail_on_rank_2})
