#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: CUDA must be present; prints the card's name and power limit.
2. build: compiles both CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together).
3. parity: each kernel against its plain PyTorch version on the card over
   a sweep of ragged shapes, word counts, cutoffs, interval planes and
   output types; bitwise equality is required.  Then each kernel's time,
   its plain version's time and its least possible time (bound) at the
   main path's shapes.
4. main path: the LJ preset at full size (n = 60 000, m = 850 000) is
   built with ``DBLIndex.build(k=64, k_prime=64, max_iters=64)`` and served
   by a ``ReachabilityServer`` over ``QueryEngine(bfs_chunk=64,
   max_iters=64, bfs_kernel=True)``: 4 rounds of 20 000 queries and 100
   inserted edges, one round through submit -> insert -> flush.  Every
   BFS-residue lane and 64 random lanes per round are checked against a
   host BFS over that round's snapshot.  Both kernels' launch counters
   must grow during this phase.
5. the ``kernels`` summary line, then the ``ok`` line last.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA's published H100 SXM peaks: HBM3 bandwidth (data sheet), and
#: the 32-bit integer rate the kernels' logic runs at: 64 INT32 lanes per
#: SM (NVIDIA H100 Tensor Core GPU Architecture whitepaper, SM table) x 132
#: SMs x 1.98 GHz, the boost clock behind the data sheet's 67 TFLOP/s of
#: float32 (132 x 128 lanes x 2 flops x 1.98 GHz).  One operation is one
#: integer instruction per lane; a 3-input logic op (LOP3) counts once.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 132 * 64 * 1.98e9

N_LJ_ROUNDS = 4
QUERIES = 20_000
INSERTS = 100
RANDOM_CHECKS = 64
BFS_CHUNK = 64
#: the label phase's batch: the queries padded to a multiple of bfs_chunk
LABEL_Q = -(-QUERIES // BFS_CHUNK) * BFS_CHUNK
#: the coalesced phase's chunk sizes: the engine's buckets up to bfs_chunk
CHUNK_QS = (16, 32, 64)
LJ_N = 60_000


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, count):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def time_ms(fn, reps=50):
    """(device ms, host-loop ms) per call of ``fn``, by CUDA events.

    Device time replays ``reps`` calls captured in one CUDA graph, so the
    Python wrapper's cost is not in it; host-loop time wraps the same
    calls issued from Python one by one, which is what a caller waits
    when the device outruns the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _events_ms(graph.replay, reps)

    def loop():
        for _ in range(reps):
            fn()
    return device, _events_ms(loop, reps)


def random_planes(rng, n, k, kp, dev):
    import torch
    from repro_torch.core import bitset
    from repro_torch.core.query import PackedLabels
    dens = rng.uniform(0.05, 0.3)
    planes = []
    for kk in (k, k, kp, kp):
        bits = rng.random((n, kk)) < dens
        bits[rng.random(n) < 0.3] = False
        planes.append(bitset.pack(torch.from_numpy(bits).to(dev)))
    return PackedLabels(*planes)


def parity_sweep(dev):
    """Kernel against plain version on the card; returns the largest
    absolute difference seen (0 when bitwise equal) and the case count."""
    import torch
    from repro_torch.kernels.bfs_prune.bfs_prune import (admit_plain,
                                                         bfs_admit_plane)
    from repro_torch.kernels.dbl_query.dbl_query import (dbl_query_verdicts,
                                                         verdicts_plain)
    rng = np.random.default_rng(0)
    variants = [  # k, k', cutoffs, interval planes, verdict out dtype
        (64, 64, "none", False, torch.int8),
        (64, 64, "m", False, torch.int8),     # the main path's
        (40, 96, "m", False, torch.int32),
        (32, 64, "md", False, torch.int8),
        (40, 96, "md", True, torch.int32),
        (64, 64, "m", True, torch.int8),
        (96, 40, "none", True, torch.int32),
    ]
    shapes = [(1, 1), (37, 37), (513, 513), (37, LJ_N), (LJ_N, 1),
              (LJ_N, 37), (LJ_N, 513), (LJ_N, LABEL_Q),
              *((LJ_N, q) for q in CHUNK_QS)]
    worst = {"verdicts_kernel": 0, "admit_kernel": 0}
    cases = 0

    def ids(q, n):
        x = rng.integers(0, n, q).astype(np.int32)
        x[::7] = n             # dead lanes: clamped to the last row
        return torch.from_numpy(x).to(dev)

    for n, q in shapes:
        for k, kp, cut, il, out_dtype in variants:
            p = random_planes(rng, n, k, kp, dev)
            u, v = ids(q, n), ids(q, n)
            v[::5] = u[::5]
            cuts = {}
            if cut in ("m", "md"):
                cuts.update(m_cut=torch.from_numpy(rng.integers(
                    90, 110, q).astype(np.int32)).to(dev), m_total=100)
            if cut == "md":
                cuts.update(d_cut=torch.from_numpy(rng.integers(
                    0, 3, q).astype(np.int32)).to(dev), d_total=1)
            ilkw = {}
            if il:
                ilkw = {name: torch.from_numpy(rng.integers(
                    -50, 50, (n, 6)).astype(np.int32)).to(dev)
                    for name in ("il_in", "il_out")}
            got = dbl_query_verdicts(*p, u, v, **cuts, **ilkw,
                                     out_dtype=out_dtype)
            want = verdicts_plain(*p, u, v, **cuts, **ilkw,
                                  out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst["verdicts_kernel"] = max(worst["verdicts_kernel"], err)
            if err or got.dtype != out_dtype:
                raise AssertionError(f"verdicts_kernel disagrees: n={n} "
                                     f"q={q} k={k} k'={kp} cut={cut} il={il}")
            cases += 1
            if q > 513:
                continue
            args = (p.bl_in, p.bl_out, p.dl_in, p.dl_out, u, v)
            got = bfs_admit_plane(*args, **cuts)
            want = admit_plain(*args, **cuts)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst["admit_kernel"] = max(worst["admit_kernel"], err)
            if err:
                raise AssertionError(f"admit_kernel disagrees: n={n} q={q} "
                                     f"k={k} k'={kp} cut={cut}")
            cases += 1
    return worst, cases


def kernel_timings(dev):
    """Kernel, plain and bound times at the main path's shapes over the
    LJ preset's 60 000 vertices with k = k' = 64 (W = 2) and clean labels
    (edge-count cutoff only): the label phase's padded verdict batch and
    the coalesced phase's 64-lane admit plane.  Each kernel's output must
    equal its plain version's, bitwise, on the timed inputs."""
    import torch
    from repro_torch.core.query import FRESH_CUT
    from repro_torch.kernels.bfs_prune.bfs_prune import (admit_plain,
                                                         bfs_admit_plane)
    from repro_torch.kernels.dbl_query.dbl_query import (dbl_query_verdicts,
                                                         verdicts_plain)
    rng = np.random.default_rng(1)
    n, w = LJ_N, 2
    p = random_planes(rng, n, 64, 64, dev)
    out = {}

    def ids(q):
        return torch.from_numpy(rng.integers(0, n, q).astype(np.int32)).to(
            dev)

    q = LABEL_Q
    u, v = ids(q), ids(q)
    cuts = dict(m_cut=torch.full((q,), FRESH_CUT, dtype=torch.int32,
                                 device=dev), m_total=0)
    # each distinct vertex's four label rows are read once, whether it is
    # a u, a v or both; per lane u, v and m_cut are read, a byte written
    rows = int(torch.unique(torch.cat([u, v])).numel())
    nbytes = rows * 4 * w * 4 + q * (4 + 4 + 4 + 1)
    # per lane: one logic op per word for Lemma 1 and each of the three
    # theorem intersections (4*Wd), one per word for each BL containment
    # test (2*Wb), and the gates and the select
    ops = q * (4 * w + 2 * w + 8)
    out["verdicts_kernel"] = timed(
        "verdicts_kernel", f"n_cap={n} W=2 Q={q} int8 out, m_cut",
        lambda: dbl_query_verdicts(*p, u, v, **cuts, out_dtype=torch.int8),
        lambda: verdicts_plain(*p, u, v, **cuts, out_dtype=torch.int8),
        nbytes, ops)

    q = CHUNK_QS[-1]
    u, v = ids(q), ids(q)
    cuts = dict(m_cut=torch.full((q,), FRESH_CUT, dtype=torch.int32,
                                 device=dev), m_total=850_000)
    args = (p.bl_in, p.bl_out, p.dl_in, p.dl_out, u, v)
    # the three vertex planes read once, each lane's ids, cutoff and three
    # query-side rows, the n*Q plane written
    nbytes = n * 3 * w * 4 + q * (3 * w * 4 + 3 * 4) + n * q
    # per output byte: one logic op per word for each BL containment test
    # and for the DL intersection, then the combine and the store's select
    ops = n * q * (2 * w + w + 2)
    out["admit_kernel"] = timed(
        "admit_kernel", f"n_cap={n} W=2 Qc={q} int8 out, m_cut",
        lambda: bfs_admit_plane(*args, **cuts),
        lambda: admit_plain(*args, **cuts), nbytes, ops)
    return out


def timed(name, shape, kernel, plain, nbytes, ops):
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"the main path's shape {shape}")
    ms, host_ms = time_ms(kernel)
    plain_ms, plain_host_ms = time_ms(plain, reps=10)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_INT_OPS_PER_S * 1e3
    return dict(shape=shape, ms=ms, host_loop_ms=host_ms,
                plain_ms=plain_ms, plain_host_loop_ms=plain_host_ms,
                bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def host_reach(n, src, dst, sources):
    """{u: bool reach mask} by a host BFS from each source over the edges."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order
    a = csr_matrix((np.ones(src.size, np.int8), (src, dst)), shape=(n, n))
    out = {}
    for s in sources:
        mask = np.zeros(n, bool)
        mask[breadth_first_order(a, int(s), directed=True,
                                 return_predecessors=False)] = True
        out[int(s)] = mask
    return out


def main_path(dev, card):
    import torch
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.kernels.bfs_prune.bfs_prune import bfs_admit_plane
    from repro_torch.kernels.dbl_query.dbl_query import (dbl_query_verdicts,
                                                         verdicts_plain)
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(1)

    dbl_query_verdicts.launches = 0
    bfs_admit_plane.launches = 0
    t = time.perf_counter()
    g = make_graph(src, dst, n, m_cap=m + N_LJ_ROUNDS * INSERTS, device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, max_iters=64,
                         check="raise", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    emit("build_index", n=n, m=m, k=64, k_prime=64, build_s=build_s,
         label_bytes=idx.label_bytes(), card=card)

    srv = ReachabilityServer(engine=QueryEngine(
        idx, bfs_chunk=BFS_CHUNK, max_iters=64, bfs_kernel=True),
        index=None)
    rounds = []
    for r in range(N_LJ_ROUNDS):
        u = rng.integers(0, n, QUERIES).astype(np.int32)
        v = rng.integers(0, n, QUERIES).astype(np.int32)
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        snap = srv.index
        g_snap = snap.graph
        saved = dict(src=g_snap.src[:g_snap.m].cpu().numpy(),
                     dst=g_snap.dst[:g_snap.m].cpu().numpy(),
                     planes=[w.clone() for w in snap.packed])
        before = srv.engine.stats.as_dict()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if r == 2:   # pipelined: the residue resolves after an insert
            srv.submit(u, v)
            ti = time.perf_counter()
            srv.insert(ns, nd)
            insert_s = time.perf_counter() - ti
            ans = srv.flush(consistency="as-of-submit")[0]
            query_s = time.perf_counter() - t - insert_s
            mode = "submit-insert-flush"
        else:
            ans = srv.query(u, v)
            query_s = time.perf_counter() - t
            ti = time.perf_counter()
            srv.insert(ns, nd)
            insert_s = time.perf_counter() - ti
            mode = "query-then-insert"
        after = srv.engine.stats.as_dict()
        residue = after["prune_hits"]["bfs"] - before["prune_hits"]["bfs"]
        hits = {k: after["prune_hits"][k] - before["prune_hits"][k]
                for k in after["prune_hits"]}
        rounds.append(dict(u=u, v=v, ans=ans, residue=residue, **saved))
        emit("round", round=r, mode=mode, queries=QUERIES,
             query_ms=query_s * 1e3, qps=QUERIES / query_s,
             insert_ms=insert_s * 1e3, inserts=INSERTS,
             rho=1 - residue / QUERIES, residue_lanes=residue,
             prune_hits=hits, card=card)
    launches = {"verdicts_kernel": dbl_query_verdicts.launches,
                "admit_kernel": bfs_admit_plane.launches}
    emit("launches", **launches)
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # the oracle: residue lanes from the snapshot's labels (the kernel's
    # plain version, so the main path's counts stay as they were read)
    checked = 0
    for r, rd in enumerate(rounds):
        uu = torch.from_numpy(rd["u"]).to(dev)
        vv = torch.from_numpy(rd["v"]).to(dev)
        verd = verdicts_plain(*rd["planes"], uu, vv).cpu().numpy()
        lanes = np.flatnonzero(verd == -1)
        if lanes.size != rd["residue"]:
            raise AssertionError(f"round {r}: {lanes.size} unknown lanes by "
                                 f"the labels, engine ran {rd['residue']}")
        extra = rng.choice(QUERIES, RANDOM_CHECKS, replace=False)
        lanes = np.union1d(lanes, extra)
        reach = host_reach(n, rd["src"], rd["dst"], np.unique(rd["u"][lanes]))
        want = np.array([reach[int(rd["u"][i])][rd["v"][i]] for i in lanes])
        bad = int((rd["ans"][lanes] != want).sum())
        if bad:
            raise AssertionError(f"round {r}: {bad} of {lanes.size} checked "
                                 "answers differ from the host BFS")
        checked += lanes.size
    emit("oracle", checked_lanes=checked, mismatches=0)
    profile_round(srv, rng, n, card)
    return launches


def profile_round(srv, rng, n, card):
    """One more served round (20 000 queries, then 100 inserts) under
    ``torch.profiler``: device time by kernel and the device's busy share
    of the round's wall time.  Runs after the launch counts were read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    u = rng.integers(0, n, QUERIES).astype(np.int32)
    v = rng.integers(0, n, QUERIES).astype(np.int32)
    ns = rng.integers(0, n, INSERTS).astype(np.int32)
    nd = rng.integers(0, n, INSERTS).astype(np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        srv.query(u, v)
        tq = time.perf_counter()
        srv.insert(ns, nd)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue   # host ops repeat their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = (us, e.count)
    device_ms = sum(us for us, _ in per_kernel.values()) / 1e3
    wall_ms = (t_end - t) * 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    emit("profile", card=card, wall_ms=wall_ms,
         query_wall_ms=(tq - t) * 1e3, insert_wall_ms=(t_end - tq) * 1e3,
         device_ms=device_ms if per_kernel else "not measured",
         device_busy_share=device_ms / wall_ms if per_kernel
         else "not measured",
         top_kernels=[{"name": k[:80], "device_ms": us / 1e3, "calls": c}
                      for k, (us, c) in top])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    _build.build(["dbl_query", "bfs_prune"])
    _build.load("dbl_query")
    _build.load("bfs_prune")
    emit("build", seconds=time.perf_counter() - t,
         libs=[str(_build.library_path(n).relative_to(ROOT))
               for n in ("dbl_query", "bfs_prune")])

    worst, cases = parity_sweep(dev)
    emit("parity", cases=cases, max_abs_err=worst, bitwise=True)
    timings = kernel_timings(dev)
    emit("kernel_times", card=card, **timings)

    launches = main_path(dev, card)

    meta = {
        "verdicts_kernel": ("src/repro_torch/kernels/csrc/dbl_query.cu",
                            "src/repro/kernels/dbl_query/dbl_query.py:94"),
        "admit_kernel": ("src/repro_torch/kernels/csrc/bfs_prune.cu",
                         "src/repro/kernels/bfs_prune/bfs_prune.py:77"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"], "host_loop_ms": t["host_loop_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
