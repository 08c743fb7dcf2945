#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: CUDA must be present; prints the card's name and power limit.
2. build: compiles the six CUDA sources from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together) and prints every kernel's registers and spills per template
   instance (``-Xptxas -v``).
3. parity: each kernel against its plain PyTorch version on the card over
   a sweep of ragged shapes, word counts (every compile-time width of the
   admit kernels' tile, W = 1..4, and a run-time width), cutoffs,
   interval planes and output types, and each streamed kernel against its
   grid twin as well; the admit kernels also on label planes at a 4-byte
   offset (scalar loads, the ring filled by 4-byte copies) and at every
   width pair W_bl, W_dl in 1..4 with Q = 8 and 37 (both lane counts);
   the verdict kernels at every width pair W_dl, W_bl in 1..4 with Q = 37
   and 512, on planes as made and at a 4-byte offset (the scalar
   instance, there with interval planes for the grid kernel), and the
   streamed one at Q = 200 003 over n = 60 000, where every block walks
   three or more chunks; bitwise equality is required.  Then each
   kernel's time, its plain version's time and its least possible time
   (bound) at the main path's shapes, and for each verdict shape the
   launch floor: ``zero_`` of the same output, timed the same way.  The
   label-plane pack kernel (``pack_label_planes``) is held bitwise to
   ``bitset.pack`` and timed the same way at the benchmark's LiveJournal
   n_cap (4 847 571 rows, k = k' = 64, uint8 planes); the CPU tests and
   the ``chip`` tests of ``tests/test_torch_pack_planes.py`` cover its
   other widths and alignments.  The BFS relax kernel (``relax_timings``,
   op ``repro_torch::bfs_relax``) is held bitwise to its plain version on
   every round of real residue BFS runs at the benchmark's two graph
   shapes (``reachbench/configs`` ``wikitalk`` and ``lj``, made on the
   card by ``reachbench.gen`` at published size, DBL k = k' = 64): a clean
   batch, then after an insert and a delete of ``RELAX_UPDATES`` edges a
   batch on dirty labels, whose lanes carry their edge-count cutoffs
   (``m_cut``); then timed at each shape's first round and at its round
   with the most frontier edges (``relax_kernel.<config>.<round>``;
   ``relax_kernel`` is wiki-Talk's busiest round).
4. main path: the LJ preset at full size (n = 60 000, m = 850 000) is
   built with ``DBLIndex.build(k=64, k_prime=64, max_iters=64)`` and served
   by a ``ReachabilityServer`` over ``QueryEngine(bfs_chunk=64,
   max_iters=64, bfs_kernel=True)``: 4 rounds of 20 000 queries and 100
   inserted edges, one round through submit -> insert -> flush.  Every
   BFS-residue lane and 64 random lanes per round are checked against a
   host BFS over that round's snapshot.  The grid kernels' launch counters
   must grow during this phase, and each insert must launch the pack
   kernel once (its counter starts from 0 here, so the ``kernels`` line
   counts its launches from this phase on).
5. dynamic: a second LJ index at full size served fully dynamically by a
   ``ReachabilityServer(rebuild_mode="auto", rebuild_dead_ratio=0.001)``
   over ``QueryEngine(streaming=True, bfs_kernel=True)``: 4 rounds of
   20 000 queries, 100 inserted edges and 500 deleted live edges (pairs
   that hold one edge slot).  The lazy rebuild falls due after the second
   round and runs at the third round's query.  Before it runs, the dirty
   index is rebuilt both ways (delta and full must give the same planes)
   and the device closure ``reach_mask`` is held against the host's
   ``_host_reach``.  64 random
   answers per round are checked against a host BFS over that round's
   live edges.  The streamed kernels' launch counters must grow here.
6. il_packed: the LJ preset at full size built with
   ``families=("dl", "bl", "il"), il_dim=4, plane_repr="packed"`` (DL/BL
   planes equal to the bool build's, interval planes equal to the CPU
   build's, no fixpoint saturated) and served by a packed engine
   (``frontier_dtype="packed"``, int32 verdicts) behind a
   ``ReachabilityServer`` beside a default index and engine: 4 rounds of
   20 000 queries and 100 inserts (one pipelined), a round that deletes
   500 single-slot pairs, a dirty round that deletes 500 more (no "il"
   hits), the lazy rebuild at the next flush (planes equal to a fresh
   build's) and a clean round.  Every answer equals the default engine's;
   the residue lanes and 64 random ones per round equal a host BFS.  A
   streaming engine on the index warns ``StreamILFallbackWarning`` once
   and takes the grid verdict kernel and the streamed admit kernel.  Then
   the interval AND's time and a profiled round.  Launch counts add to
   the grid kernels' and the streamed admit kernel's.
7. sharded: the vertex-sharded layout (``repro_torch.core.distributed``)
   through the LJ lifecycle at full width: ``build_vertex_sharded``
   (k = k' = 64, ``max_iters=64``), two inserts of 100 edges, a delete of
   500 single-slot pairs, and ``rebuild_vertex_sharded`` in "delta" and in
   "full" mode, with bool planes, with ``plane_repr="packed"`` and with
   ``families=("dl", "bl", "il"), il_dim=4``.  At every step the shard's
   planes, words, interval planes, landmarks, leaf masks, ``saturated``,
   the fixpoints' rounds and the rebuild ``info`` dicts must equal the
   replicated port's on the same card bit for bit.  First as a world of
   one over NCCL in this process, then as 4 gloo ranks sharing the card
   (NCCL refuses two ranks on one device), spawned from here with a
   ``FileStore`` and a timeout, each holding its row block against a
   replicated index it builds itself; if gloo refuses CUDA tensors, the
   refusal is printed instead.  Each lifecycle is followed by a serving
   stream on the shard: a ``ReachabilityServer`` over
   ``QueryEngine(vertex_mesh=mesh)`` beside a replicated server on the
   same card, two rounds of 20 000 queries and 100 inserts (one
   pipelined), a delete of 500 single-slot pairs, a dirty round, the
   engine's delta rebuild and a clean round; every answer, the engine
   stats and the rebuild info equal the replicated server's, and on rank
   0 the residue lanes and 64 random lanes a round equal a host BFS.  The
   serving path's collectives are counted (an all-gather or broadcast
   fails the run), and the world of one profiles one more round on the
   bool shard.  Lines ``sharded_world1``, ``sharded_serve_world1``,
   ``sharded_serve_profile``, ``sharded_4rank`` and
   ``sharded_serve_4rank`` (or ``sharded_4rank_refused``) and
   ``sharded_bytes``.  No kernel is on this path.  Every lifecycle step
   also runs with the sparse halo (``halo_mode="sparse", hub_count=8``,
   the two modes in turns, after one untimed build in each world), held
   bitwise the same way with equal rounds;
   lines ``sharded_sparse_world1`` and ``sharded_sparse_4rank`` give the
   steps' ms beside the dense ones, both modes' halo telemetry (at 4
   ranks the sparse one must model fewer bytes) and the calls and bytes
   counted at ``all_to_all_single`` and ``all_reduce``; a world of one
   has no pairs, so its sparse rounds must all be local with no
   ``all_to_all_single``.
8. query_mesh: in the same two worlds, a ``ReachabilityServer(mesh=
   distributed.query_mesh())`` over ``QueryEngine(bfs_kernel=True)``
   beside a replicated server, both on a fresh LJ index at full size:
   a round of 20 000 queries then 100 inserts, a pipelined round, a
   delete of 500 single-slot pairs, a dirty round, the delta rebuild and
   a clean round.  Every answer and the engine stats equal the
   replicated server's, and each label phase issues one all-gather and
   no other collective.  The kernels' launches on the mesh server's
   calls add to the grid kernels' counts.  Lines ``query_mesh_world1``
   and ``query_mesh_4rank``.  Then, in the same two worlds, the
   auto-partitioned scheme (``gspmd_lifecycle``) on a launch mesh, (1, 1)
   and (2, 2): after one untimed build, ``distributed_build`` (k = k' =
   64, ``max_iters=64``), ``distributed_label_verdicts`` on 20 000 lanes,
   two ``distributed_insert``s of 100 edges, a delete of 500 single-slot
   pairs, a dirty query of 2 048 lanes, the rebuild, ``shard_index`` onto
   the 1-axis mesh and ``QueryEngine(mesh=<that mesh>, bfs_kernel=True)``
   over ``reach_place_index``, each rank's blocks and every answer equal
   to the replicated port's on the same card bit for bit, one
   ``all_reduce`` a fixpoint round.  Lines ``gspmd_world1`` and
   ``gspmd_4rank``: ms beside the replicated steps, rounds, the
   ``all_reduce`` calls and bytes a round, the gathers; the verdict and
   admit kernels' launches add to their counts.
9. baselines: the paper's baselines beside DBL on the LJ preset at full
   size.  A ``DBLIndex`` (k = k' = 64, ``max_iters=64``) served by a
   ``ReachabilityServer`` over ``QueryEngine(bfs_chunk=64, max_iters=64,
   bfs_kernel=True)`` and an ``IPIndex`` (k = 8) on the same graph; two
   rounds of 2 048 queries answered by the server, by B-BFS
   (``bbfs.query``, chunk 64, ``max_iters=64``, on the server's graph)
   and by ``IPIndex.query``, all equal and equal to a host BFS on every
   residue lane and 64 random lanes, then 100 inserts into the server
   and the IP index.  ``dag_stats`` and ``scc_condense_numpy`` on the
   host, and ``scc_fwbw_round`` on the card with every vertex
   unclassified, whose mask must equal Kosaraju's SCC of vertex 0.  The
   reachability-filtered sampler (32 seeds, fanouts 15 and 10, the 4
   vertices of highest in-degree as targets) through the DBL index and,
   from the same seed, through a host BFS: equal subgraphs.  Both example
   twins run as subprocesses on the card at their default arguments and
   must end in ``OK``.  One ``baselines`` line: the checks, DBL's build
   beside IP-lite's, each round's query and insert times, the SCC times
   and the sampler's.  The grid kernels' launches add to their counts.
10. aot: the AOT cache (``serve/aot.py``) on the LJ preset at full size
   (k = k' = 64, ``max_iters=64``, bfs_chunk 64), for
   ``QueryEngine(bfs_kernel=True)`` and ``QueryEngine(bfs_kernel=True,
   streaming=True)`` (``AOT_RUNS``): this process warms an engine up
   into an empty cache, which exports and saves the label phase at the
   20 032-lane batch and, for each chunk bucket (16, 32, 64), the
   residue's prologue and BFS round (``aot_store`` lines: ms per export
   and save, bytes per ``.pt2``).  A fresh child process
   (``aot_child``) warms up from that cache, where every file must hit
   and none miss, and answers a round of 20 000 queries through the
   loaded programs; it times rounds through them against a live engine
   on a second copy of the index (loaded, live, live, loaded), profiles
   a loaded round (every dispatch must reach a loaded program, and both
   of the engine's kernels must launch), then inserts 100 edges,
   deletes 500 single-slot pairs and answers a second round (dirty
   labels: live phases); one child serves both engines in turn.  A
   second child starts the first engine from an empty cache.
   Both rounds must equal a live engine's in this process bitwise, and
   the first round's residue lanes and 64 random lanes of each round a
   host BFS over that round's edges.
   Lines ``aot_store``, ``aot_child`` (load ms per file, seconds from a
   child's start to its first answered batch with a warm and with an
   empty cache, round ms loaded and live) and ``aot``; the launches from
   loaded programs add to the kernels' counts.  Then ``warmup``
   (``warmup_phase``): two fresh children serve the same LJ stream over
   ``QueryEngine(bfs_kernel=True)``, one after ``warmup`` (the batch and
   every chunk bucket) and one without: a round of 20 000 queries, a
   second, a delete of 500 single-slot pairs, the delta rebuild and a
   round; answers equal this process's engine's, and the warmed engine's
   ``dispatch_shape_counts()`` equal after the warmup, the first round and
   the rebuild.  One ``warmup`` line (first-round ms with and without the
   warmup); the children's launches add to the kernels' counts.
11. gnn: the GNN family (``repro_torch.models.gnn``) at each model's full
   CONFIG, TF32 off.  PNA on ``full_graph_sm`` (2 708 nodes, 10 556
   uniform random edges, 1 433 features, 7 classes); NequIP, MACE and
   DimeNet on ``molecule`` (128 graphs of 30 atoms and their 64 shortest
   pairs from ``generators.molecules``, every DimeNet triplet, a random
   energy target per graph).  Each model: energy invariance under a
   random rotation (the geometric ones), the forward, forces and one SGD
   step (``w - 0.05 g``) held against the same module on the CPU with the
   same parameters (forward, forces, loss and the gradient vector within
   |d| <= 1e-3 |want| + 1e-4 max|want|), the forward, forces and step
   timed 5 times each from the initial parameters, and one step profiled
   (device busy share); one ``gnn_model`` line each.  Then the example's
   path on the LJ preset at full size: a fresh index (k = k' = 64)
   filters ``minibatch_lg``'s samples (1 024 uniform seeds, fanouts 15
   and 10, the 4 vertices of highest in-degree as targets), each equal
   to the sample a host BFS over the index's live edges filters from the
   same draws; PNA's CONFIG (602 features, 41 classes) steps on each, and
   100 edges are inserted a round, 3 rounds (``gnn_minibatch`` line).
   The sampler's verdict launches add to the grid kernel's count.  The
   twin ``examples/gnn_reachability_torch.py`` runs at its defaults on
   the card beside the CPU holds and must end in ``OK``; one ``gnn``
   summary line.
12. mind: MIND (``repro_torch.models.recsys.mind``) at its full CONFIG
   (2 097 152 items x 64, a 512 MiB float32 table), TF32 off: one loss
   step (forward, backward, ``w - 0.5 g``) at batch 256 with the config's
   50 history slots and 512 negatives, and ``retrieval_scores`` for 16
   users against 1 000 000 uniform candidates, held against the same
   module on the CPU (the loss, every gradient, the item table's on the
   rows the batch touches, and the scores, within ``GNN_TOL``); 5 timed
   steps and retrievals, one step profiled; one ``mind`` line.  No
   kernel of the port's is on this path.
13. lm: the transformer family (``repro_torch.models.transformer``,
   ``serve/decode.py``) at full width, TF32 off: tinyllama-1.1b and
   qwen1.5-0.5b whole, gemma2-27b and moonshot-v1-16b-a3b cut to 4
   layers, arctic-480b to 1 (``LM_RUNS``), each drawn on the card from a
   seed.  In the config's dtype (bfloat16): prefill 4 x 32, a decode
   step, ``generate`` of 32 greedy steps (examples/serve_lm.py's call;
   tokens/s), an SGD step on 4 x 128 tokens, a profiled decode step and
   SGD step (busy share); tinyllama and qwen also prefill 4 x 2 048 (two
   kv chunks).  Then, in float32 compute with no MoE drops, prefill then
   ``decode_step`` against the forward at tests/test_models_lm.py's
   tolerances, and for gemma2 also past its window (prefill 5 120,
   decode at 5 120 against the forward on 6 144 tokens); tinyllama and
   qwen in float32 held against the same module on the CPU (prefill,
   four decode steps fed the card's greedy ids, the loss; ``GNN_TOL``).
   The twin ``examples/serve_lm_torch.py`` runs beside it on the card and
   must end in ``OK``.  One ``lm_model`` line a config, one ``lm`` line.
   No kernel of the port's is on this path.
14. train: the training path (``repro_torch.train``, ``launch/train.py``)
   at full width (``TRAIN_RUNS``): timed steps, accum-2 steps, a profiled
   step, the optimizer update alone and the holds; the kill-and-restart
   check on qwen1.5-0.5b in a subprocess; the example twin and the
   launcher (then ``--resume``).  Lines ``train_model``, ``train_restart``,
   ``train``.
15. moe_sharded and train_sharded (``mesh_phases``): the expert-parallel
   MoE (``models.transformer.moe_sharded``) at moonshot-v1-16b-a3b's full
   MoE width (64 experts, d_model 2048, top-6, d_ff 1408, 2 shared
   experts, bf16 weights) over 4 096 tokens without drops, first as a
   world of one over NCCL in this process (mesh (1, 1)), then over 4 gloo
   ranks sharing the card on meshes (2, 2) and (1, 4) (NCCL refuses two
   ranks on one device; a refusal of gloo's is printed and fails the
   run).  Each rank holds its token block and its experts: the forward,
   the forward and backward and the all-to-all alone are timed in bf16;
   in float32 with aux weight 0, ``y`` and every gradient (summed over
   the ranks) are held against the local ``moe_ffn`` on the whole batch
   (``MOE_Y_TOL``, ``MOE_GRAD_TOL``), and ``aux`` against the per-cell
   estimator.  The sharded train state
   (``make_train_step(state_shardings=)``): qwen1.5-0.5b whole with AdamW
   on mesh (1, 1), two steps equal to the unsharded step's bit for bit
   under deterministic algorithms; moonshot cut to 2 layers
   (``moe_impl="shard_map"``, Adafactor, float32 compute and weights, no
   drops, aux weight 0) on (2, 2) over the 4 gloo ranks, two steps on
   4 x 128 tokens; after the first, the gathered gradients held against
   the single-process step's on the card (its tokens routed to the
   sharded run's experts), and the gathered parameters against the
   single-process update by those gradients (``train_sharded_run`` says
   why not against its parameters).  Beside them the dry run
   (``python -m repro_torch.launch.dryrun --all``) on the host.  Lines
   ``moe_sharded_world1``, ``moe_sharded_4rank`` (one a layout),
   ``moe_sharded``, ``train_sharded_world1``, ``train_sharded_4rank``,
   ``dryrun``, ``train_sharded``.  No kernel of the port's is on this
   path.
16. the ``kernels`` summary line, then the ``ok`` line last.
"""
import functools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
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
#: the benchmark's LiveJournal configuration: n_cap of the pack kernel's
#: main-path shape (every insert repacks four (n_cap, 64) planes)
PACK_N = 4_847_571
#: the widest admit plane of the parity sweep: more lane groups than a
#: block of either admit kernel has threads
ADMIT_MAX_Q = 2_500
#: the verdict sweep's multi-chunk batch: more than three chunks for
#: every persistent block of the streamed kernel
MULTI_CHUNK_Q = 200_003
#: the dynamic phase: deleted live edges per round and the server's
#: tombstone ratio (850 of the LJ preset's 850 000 edges)
DELETES = 500
DEAD_RATIO = 0.001
#: the il_packed phase: served rounds before the delete rounds, and the
#: interval family's knobs
N_IL_ROUNDS = 4
IL_FAM = dict(families=("dl", "bl", "il"), il_dim=4, il_seed=0)
#: the sharded phase: its configurations, insert batches, the ranks of
#: the gloo world on the one card, and that world's time limit
SHARDED_CONFIGS = (("bool", {}), ("packed", dict(plane_repr="packed")),
                   ("il", IL_FAM))
SHARDED_INSERTS = 2
#: the sharded serving stream's rounds that insert
SHARDED_SERVE_ROUNDS = 2
SHARDED_RANKS = 4
SHARDED_TIMEOUT_S = 600
#: the sparse halo's setting beside each sharded lifecycle: the reference
#: bench's (``benchmarks/bench_dbl_perf.py:614``)
SPARSE_HALO = dict(halo_mode="sparse", hub_count=8)
# the auto-partitioned scheme's lifecycle (``gspmd_lifecycle``): inserts,
# and the lanes of its dirty query
GSPMD_INSERTS = 2
GSPMD_QUERIES = 2_048
#: the baselines phase: queries and rounds, IP-lite's hashes, the
#: sampler's seed vertices, fanouts and targets, and the example twins
#: (each run at its default arguments on the phase's device)
BASE_QUERIES = 2_048
BASE_ROUNDS = 2
IP_K = 8
SAMPLE_SEEDS = 32
FANOUTS = (15, 10)
SAMPLE_TARGETS = 4
EXAMPLES = {"quickstart_torch": ("examples/quickstart_torch.py",),
            "dynamic_reachability_torch": (
                "examples/dynamic_reachability_torch.py",)}
EXAMPLE_TIMEOUT_S = 300
#: the gnn phase: each model's full CONFIG at a shape of
#: ``configs/shapes.py``, with the class counts the reference's
#: ``launch/cells.py`` gives each shape (Cora 7, Reddit 41, molecules 16);
#: timed forwards and steps per model (after one untimed of each); rounds
#: of sample, step and inserts on the LJ preset; the example's SGD rate;
#: the tolerance of the card-against-CPU holds (float32 both, TF32 off)
#: and of rotation invariance: |got - want| <= rtol |want| + atol max|want|
GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "molecule": 16}
GNN_REPS = 5
GNN_ROUNDS = 3
GNN_LR = 0.05
GNN_TOL = dict(rtol=1e-3, atol=1e-4)
GNN_EXAMPLE = {"gnn_reachability_torch": (
    "examples/gnn_reachability_torch.py",)}
#: the mind phase: the loss step's batch (the config's hist_len and
#: n_neg), the timed steps, the retrieval's users and candidates
MIND_BATCH = 256
MIND_REPS = 5
MIND_LR = 0.5
MIND_USERS = 16
MIND_CANDIDATES = 1_000_000
#: the lm phase: (name, config module, layers kept or None for all), at
#: full width; examples/serve_lm.py's batch, prompt and greedy steps; the
#: long prefills (two kv chunks; gemma2 past its 4 096 window, held
#: against a forward on 6 144 tokens at position 5 120); the SGD step's
#: sequence and rate (small: the weights must stay finite at full width);
#: the self-consistency tolerances of tests/test_models_lm.py (prefill,
#: decode); timed repetitions
LM_RUNS = (("tinyllama-1.1b", "tinyllama_11b", None),
           ("qwen1.5-0.5b", "qwen15_05b", None),
           ("gemma2-27b", "gemma2_27b", 4),
           ("moonshot-v1-16b-a3b", "moonshot_v1_16b_a3b", 4),
           ("arctic-480b", "arctic_480b", 1))
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 32, 32
LM_LONG = 2_048
GEMMA_LONG = (5_120, 6_144)
LM_TRAIN_SEQ = 128
LM_LR = 1e-4
LM_PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
LM_DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
LM_REPS = 3
#: decode steps held against the CPU, fed the card's greedy ids
LM_CPU_STEPS = 4
LM_EXAMPLE = {"serve_lm_torch": ("examples/serve_lm_torch.py",)}
#: the train phase (``repro_torch.train``): tinyllama whole (AdamW on
#: float32 weights) and gemma2 cut to 4 layers (Adafactor on bfloat16
#: weights) at full width, bf16 compute, on lm_batches of 4 x 128 under a
#: cosine schedule: warm-up and timed steps, steps at accum 2 (2 x 2 x
#: 128), repetitions of the optimizer update alone; the kill-and-restart
#: check on qwen1.5-0.5b whole in a subprocess with deterministic
#: algorithms; the holds' tolerances: the reference test's for accum 2
#: against 1 (tests/test_train_substrate.py), the CPU tests' for the
#: update on the card against the CPU (float32 leaves as in
#: tests/test_torch_train_optim.py, bfloat16 ones as in
#: tests/test_torch_train_loop.py), that update at a rate of 1e-2
TRAIN_RUNS = (("tinyllama-1.1b", "tinyllama_11b", None),
              ("gemma2-27b", "gemma2_27b", 4))
TRAIN_BATCH, TRAIN_SEQ = 4, 128
TRAIN_SCHEDULE = dict(base_lr=1e-4, warmup=2, total=1_000)
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_ACCUM_STEPS = 2, 10, 3
TRAIN_UPDATE_REPS = 3
TRAIN_STEP_TOL = dict(rtol=2e-4, atol=2e-5)
TRAIN_OPT_TOL = dict(rtol=1e-6, atol=1e-7)
TRAIN_HOLD_LR = 1e-2
RESTART_RUN = ("qwen1.5-0.5b", "qwen15_05b", None)
RESTART_SCHEDULE = dict(base_lr=1e-3, warmup=2, total=100)
TRAIN_CHILD_TIMEOUT_S = 600
#: moe_sharded and train_sharded: moonshot-v1-16b-a3b's MoE at full width
#: (64 experts, d_model 2048, top-6, d_ff 1408, 2 shared experts, bf16
#: weights) over 4 096 tokens, no drops (capacity factor 2 E / K), on mesh
#: (1, 1) in a world of one and on (2, 2) and (1, 4) over 4 gloo ranks;
#: the model cut from 48 layers to 2, float32 compute and weights, for
#: the sharded train steps on (2, 2) (4 x 128 tokens, a rate of 1e-2 from
#: the first step, two steps, the first held); qwen1.5-0.5b whole for the
#: bitwise check on (1, 1).  The MoE holds run in float32:
#: |got - want| <= rtol |want| + frac max|want| as (rtol, frac), y at the
#: CPU test's rtol and the gradients at its rtol 5e-3.
MESH_RUN = dict(module="moonshot_v1_16b_a3b", moe_tokens=4_096,
                train_layers=2, bitwise_module="qwen15_05b", smoke=False)
MOE_LAYOUTS = ((2, 2), (1, 4))
MOE_REPS = 2
MOE_Y_TOL = (2e-4, 1e-5)
MOE_GRAD_TOL = (5e-3, 1e-4)
TRAIN_SHARDED_SCHEDULE = dict(base_lr=1e-2, warmup=0, total=50)
TRAIN_SHARDED_STEPS = 2
#: the sharded step's gradients against the single-process step's,
#: |got - want| <= rtol |want| + frac max|want| as (rtol, frac): float32
#: sums in another order (a gradient that cancels keeps the rounding of its
#: terms, a fraction of the leaf's largest)
TRAIN_SHARDED_GRAD_TOL = (1e-3, 1e-5)
#: a token may route to other experts in the single-process step only
#: where its top k + 1 router probabilities sit this close to a tie
ROUTING_TIE = 1e-5
MESH_RANKS = 4
MESH_TIMEOUT_S = 300


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
    """Kernels against their plain versions on the card, and each streamed
    kernel against its grid twin; returns the largest absolute difference
    seen per kernel (0 when bitwise equal) and the case count."""
    import warnings

    import torch
    from repro_torch.kernels.bfs_prune.bfs_prune import (
        admit_plain, admit_streamed_plain, bfs_admit_plane,
        bfs_admit_plane_streamed)
    from repro_torch.kernels import _build
    from repro_torch.kernels.dbl_query.dbl_query import (
        dbl_query_verdicts, dbl_query_verdicts_streamed, freshness_rows,
        streamed_verdicts_rows, verdict_geometry, verdicts_plain,
        verdicts_streamed_plain)
    from repro_torch.kernels.dbl_query.ops import (StreamILFallbackWarning,
                                                   verdicts_device)
    from repro_torch.core.query import PackedLabels
    rng = np.random.default_rng(0)
    variants = [  # k, k', cutoffs, interval planes, verdict out dtype
        (64, 64, "none", False, torch.int8),
        (64, 64, "m", False, torch.int8),     # the main path's
        (64, 64, "md", False, torch.int8),    # the dynamic phase's
        (40, 96, "m", False, torch.int32),
        (32, 64, "md", False, torch.int8),
        (96, 40, "md", False, torch.int32),
        (40, 96, "md", True, torch.int32),
        (64, 64, "m", True, torch.int8),
        (96, 40, "none", True, torch.int32),
        (128, 128, "md", False, torch.int8),  # W = 4
        (128, 32, "m", False, torch.int32),   # W_bl = 4, W_dl = 1
        (160, 64, "md", False, torch.int8),   # the run-time-width tile
    ]
    # Q = 2 and 8, Q % 8 == 4 (36) and ragged Q (37) at n = 60 000, and a
    # Q with more lane groups than a block has threads (2 500: two slabs)
    shapes = [(1, 1), (37, 37), (513, 513), (37, LJ_N), (LJ_N, 1),
              (LJ_N, 2), (LJ_N, 8), (LJ_N, 36), (LJ_N, 37), (LJ_N, 513),
              (1000, ADMIT_MAX_Q), (LJ_N, LABEL_Q),
              *((LJ_N, q) for q in CHUNK_QS)]
    names = ("verdicts_kernel", "admit_kernel", "streamed_verdicts_kernel",
             "streamed_admit_kernel")
    worst = dict.fromkeys(names, 0)
    cases = 0

    def ids(q, n):
        x = rng.integers(0, n, q).astype(np.int32)
        x[::7] = n             # dead lanes: clamped to the last row
        return torch.from_numpy(x).to(dev)

    def hold(name, got, *wants, what=""):
        nonlocal cases
        torch.cuda.synchronize()
        for want in wants:
            err = int((got.long() - want.long()).abs().max()) \
                if got.numel() else 0
            worst[name] = max(worst[name], err)
            if err or got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name} disagrees: {what}")
        cases += 1

    def offset(t):
        """t in storage at a 4-byte offset: no longer 16-byte aligned."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    def admit_cases(p, u, v, cuts, what):
        """Both admit kernels against admit_plain and each other, on the
        planes as made (vector loads, 16-byte ring copies) and at a 4-byte
        offset (scalar loads, 4-byte ring copies); the streamed kernel at
        its default chunk and at one that divides no n of the sweep."""
        rows = freshness_rows(**cuts)
        fresh = None if rows is None else rows.all(0).to(torch.int32)
        planes = (p.bl_in, p.bl_out, p.dl_in, p.dl_out)
        plain = admit_plain(*planes, u, v, **cuts)
        plain_s = admit_streamed_plain(*planes, u, v, fresh)
        for moved in (False, True):
            args = (*(map(offset, planes) if moved else planes), u, v)
            at = f"{what} offset={moved}"
            grid = bfs_admit_plane(*args, **cuts)
            hold("admit_kernel", grid, plain, what=at)
            for nb in (None, 36):
                hold("streamed_admit_kernel",
                     bfs_admit_plane_streamed(*args, **cuts, n_block=nb),
                     plain_s, grid, what=f"{at} n_block={nb}")

    def verdict_cases(p, u, v, cuts, what):
        """Both verdict kernels against their plain versions, and the
        streamed one against its grid twin, on the planes as made (vector
        row loads) and at a 4-byte offset (the scalar instance), where the
        grid kernel also takes interval planes; int8 and int32 out."""
        rows = freshness_rows(**cuts)
        n = p.dl_in.shape[0]
        for moved in (False, True):
            pp = [offset(t) for t in p] if moved else list(p)
            at = f"{what} offset={moved}"
            for out_dtype in (torch.int8, torch.int32):
                grid = dbl_query_verdicts(*pp, u, v, **cuts,
                                          out_dtype=out_dtype)
                hold("verdicts_kernel", grid, verdicts_plain(
                    *p, u, v, **cuts, out_dtype=out_dtype), what=at)
                hold("streamed_verdicts_kernel",
                     streamed_verdicts_rows(*pp, u, v, rows,
                                            out_dtype=out_dtype),
                     verdicts_streamed_plain(*p, u, v, rows, out_dtype),
                     grid, what=at)
            if moved:
                il = {name: torch.from_numpy(rng.integers(
                    -50, 50, (n, 6)).astype(np.int32)).to(dev)
                    for name in ("il_in", "il_out")}
                hold("verdicts_kernel", dbl_query_verdicts(
                    *pp, u, v, **cuts, **{k: offset(t) for k, t in
                                          il.items()}),
                     verdicts_plain(*p, u, v, **cuts, **il),
                     what=f"{at} il")

    for n, q in shapes:
        for k, kp, cut, il, out_dtype in variants:
            what = f"n={n} q={q} k={k} k'={kp} cut={cut} il={il}"
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
            grid = dbl_query_verdicts(*p, u, v, **cuts, **ilkw,
                                      out_dtype=out_dtype)
            hold("verdicts_kernel", grid, verdicts_plain(
                *p, u, v, **cuts, **ilkw, out_dtype=out_dtype), what=what)
            if il:
                # the reference's rule: streaming with interval planes
                # warns and takes the grid kernel
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    got = verdicts_device(
                        PackedLabels(*p), u, v, **cuts,
                        il=(ilkw["il_in"], ilkw["il_out"]),
                        out_dtype=out_dtype, streaming=True)
                if not any(issubclass(w.category, StreamILFallbackWarning)
                           for w in caught):
                    raise AssertionError("streaming + il did not warn")
                hold("verdicts_kernel", got, grid, what="streaming+il")
            else:
                rows = freshness_rows(**cuts)
                hold("streamed_verdicts_kernel",
                     dbl_query_verdicts_streamed(*p, u, v, **cuts,
                                                 out_dtype=out_dtype),
                     verdicts_streamed_plain(*p, u, v, rows, out_dtype),
                     grid, what=what)
            if q <= ADMIT_MAX_Q:
                admit_cases(p, u, v, cuts, what)
    # every width pair the tile compiles, at Q = 8 (the grid kernel's 8
    # lanes a thread where 2*W_bl + W_dl <= 6, 64-bit stores) and Q = 37
    # (4 lanes, bytes); the sweep above adds the run-time width
    for wb in range(1, 5):
        for wd in range(1, 5):
            for q in (8, 37):
                p = random_planes(rng, 1000, 32 * wb, 32 * wd, dev)
                u, v = ids(q, 1000), ids(q, 1000)
                cuts = dict(m_cut=torch.from_numpy(rng.integers(
                    90, 110, q).astype(np.int32)).to(dev), m_total=100,
                    d_cut=torch.from_numpy(rng.integers(
                        0, 3, q).astype(np.int32)).to(dev), d_total=1)
                admit_cases(p, u, v, cuts,
                            f"n=1000 q={q} W_bl={wb} W_dl={wd} cut=md")

    def md_cuts(q):
        return dict(m_cut=torch.from_numpy(rng.integers(
            90, 110, q).astype(np.int32)).to(dev), m_total=100,
            d_cut=torch.from_numpy(rng.integers(
                0, 3, q).astype(np.int32)).to(dev), d_total=1)

    # every compile-time width pair of the verdict tile, at a ragged Q and
    # at a whole number of blocks and chunks; the sweep above adds the
    # run-time width
    for wd in range(1, 5):
        for wb in range(1, 5):
            for q in (37, 512):
                p = random_planes(rng, 1000, 32 * wd, 32 * wb, dev)
                u, v = ids(q, 1000), ids(q, 1000)
                v[::5] = u[::5]
                verdict_cases(p, u, v, md_cuts(q),
                              f"n=1000 q={q} W_dl={wd} W_bl={wb} cut=md")
    # the streamed kernel's walk beyond one wave: its prefetch of the next
    # chunk's rows and ids
    q = MULTI_CHUNK_Q
    g = verdict_geometry(q, 2, 2, _build.sm_count(dev), True, True)
    if -(-q // g.threads) < 3 * g.blocks:
        raise AssertionError(f"Q={q} gives a block fewer than 3 chunks: {g}")
    p = random_planes(rng, LJ_N, 64, 64, dev)
    u, v = ids(q, LJ_N), ids(q, LJ_N)
    v[::5] = u[::5]
    verdict_cases(p, u, v, md_cuts(q), f"n={LJ_N} q={q} W=2 cut=md")
    return worst, cases


def kernel_timings(dev):
    """Kernel, plain and bound times at the main paths' shapes over the
    LJ preset's 60 000 vertices with k = k' = 64 (W = 2): the label
    phase's padded verdict batch and the coalesced phase's 64-lane admit
    plane, the grid kernels with clean labels (the engine passes the
    edge-count cutoff and the tombstone cutoff of its dirty gate, two
    freshness rows, in either state; ``verdicts_kernel_ncut1`` times the
    grid verdict kernel on the edge-count row alone, as it was passed
    before the gate), the streamed kernels with dirty labels.  Each
    kernel is timed through its custom op on the pre-combined freshness
    rows the wrappers hand it, its plain version on the cutoffs.  Each
    kernel's output must equal its plain version's, bitwise, on the timed
    inputs.  Each shape also gets its launch floor: ``zero_`` of
    its int8 output ((Q,) verdicts, (n_cap, Qc) admit plane), timed the
    same way."""
    import torch
    from repro_torch.core.query import FRESH_CUT
    from repro_torch.kernels.bfs_prune.bfs_prune import (
        admit_op, admit_plain, admit_streamed_plain, streamed_admit_row)
    from repro_torch.kernels.dbl_query.dbl_query import (
        freshness_rows, streamed_verdicts_rows, verdicts_op, verdicts_plain,
        verdicts_streamed_plain)
    from repro_torch.kernels.pack_planes.pack_planes import (pack_op,
                                                             pack_plain)
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
    # a u, a v or both; per lane u, v and each freshness row are read, a
    # byte written
    rows = int(torch.unique(torch.cat([u, v])).numel())
    # per lane: one logic op per word for Lemma 1 and each of the three
    # theorem intersections (4*Wd), one per word for each BL containment
    # test (2*Wb), and the gates and the select
    ops = q * (4 * w + 2 * w + 8)
    # the kernels take the cutoffs as freshness rows (the custom ops'
    # operands); the plain versions the cutoffs themselves.  The label
    # phase on clean labels: the tombstone row all ones (the gate False)
    gated = dict(cuts, d_cut=torch.ones(q, dtype=torch.int32, device=dev),
                 d_total=1)
    for name, kw, ncut in (("verdicts_kernel", gated, 2),
                           ("verdicts_kernel_ncut1", cuts, 1)):
        rows_k = freshness_rows(**kw)
        out[name] = timed(
            name, f"n_cap={n} W=2 Q={q} int8 out, ncut={ncut}",
            lambda rows_k=rows_k: verdicts_op(*p, u, v, rows_k, None, None,
                                              True),
            lambda kw=kw: verdicts_plain(*p, u, v, **kw,
                                         out_dtype=torch.int8),
            rows * 4 * w * 4 + q * (4 + 4 + ncut * 4 + 1), ops, floor_q=q)

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
    fresh = freshness_rows(**cuts)[0]
    out["admit_kernel"] = timed(
        "admit_kernel", f"n_cap={n} W=2 Qc={q} int8 out, m_cut",
        lambda: admit_op(*args, fresh),
        lambda: admit_plain(*args, **cuts), nbytes, ops, floor_q=n * q)

    # the dynamic phase's dirty label phase: both freshness rows (all
    # fresh by edge count, all stale by tombstone), as the engine passes
    q = LABEL_Q
    u, v = ids(q), ids(q)
    rows2 = freshness_rows(
        torch.full((q,), FRESH_CUT, dtype=torch.int32, device=dev), 0,
        torch.zeros(q, dtype=torch.int32, device=dev), 1)
    rows = int(torch.unique(torch.cat([u, v])).numel())
    nbytes = rows * 4 * w * 4 + q * (4 + 4 + 2 * 4 + 1)
    ops = q * (4 * w + 2 * w + 8)
    out["streamed_verdicts_kernel"] = timed(
        "streamed_verdicts_kernel",
        f"n_cap={n} W=2 Q={q} int8 out, ncut=2",
        lambda: streamed_verdicts_rows(*p, u, v, rows2,
                                       out_dtype=torch.int8),
        lambda: verdicts_streamed_plain(*p, u, v, rows2, torch.int8),
        nbytes, ops, floor_q=q)

    # the dynamic phase's coalesced chunk on clean labels: the DL term on
    # for every lane (one pre-combined freshness row of ones)
    q = CHUNK_QS[-1]
    u, v = ids(q), ids(q)
    fresh = torch.ones(q, dtype=torch.int32, device=dev)
    args = (p.bl_in, p.bl_out, p.dl_in, p.dl_out, u, v)
    nbytes = n * 3 * w * 4 + q * (3 * w * 4 + 3 * 4) + n * q
    ops = n * q * (2 * w + w + 2)
    out["streamed_admit_kernel"] = timed(
        "streamed_admit_kernel", f"n_cap={n} W=2 Qc={q} int8 out, fresh row",
        lambda: streamed_admit_row(*args, fresh),
        lambda: admit_streamed_plain(*args, fresh), nbytes, ops,
        floor_q=n * q)

    # the insert's repack at LiveJournal's n_cap: four (n_cap, 64) uint8
    # 0/1 planes to (n_cap, 2) words; each plane byte read once, each word
    # written once; a multiply, a shift and an OR per 8 bytes
    n, k = PACK_N, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    planes = tuple((torch.rand((n, k), generator=gen, device=dev) < 0.3)
                   .to(torch.uint8) for _ in range(4))
    out_bytes = 4 * n * 2 * 4
    out["pack_planes_kernel"] = timed(
        "pack_planes_kernel", f"n_cap={n} k=k'=64 uint8 planes",
        lambda: pack_op(*planes), lambda: pack_plain(*planes),
        4 * n * k + out_bytes, 4 * n * k // 8 * 3, floor_q=out_bytes,
        plain_reps=2)
    del planes
    return out


def timed(name, shape, kernel, plain, nbytes, ops, floor_q=None,
          plain_reps=10, plain_waits=False):
    """Kernel and plain times after a bitwise check on the timed inputs
    (a tensor or a tuple of them; ``max_abs_err`` is its largest
    difference, 0 or it raises), with the bound; with ``floor_q``, also
    ``launch_floor_ms``: the device time of ``zero_`` on ``floor_q`` int8
    bytes, the least a launch that writes the kernel's output takes.
    ``plain_waits``: the plain version reads the host, which no CUDA
    graph can capture, so its time is the host loop's alone."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max((int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want)), default=0)
    if len(got) != len(want) or err or any(
            a.dtype != b.dtype or a.shape != b.shape
            for a, b in zip(got, want)):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"the main path's shape {shape}")
    del got, want
    ms, host_ms = time_ms(kernel)
    if plain_waits:
        plain()
        plain_ms = plain_host_ms = _events_ms(
            lambda: [plain() for _ in range(plain_reps)], plain_reps)
    else:
        plain_ms, plain_host_ms = time_ms(plain, reps=plain_reps)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_INT_OPS_PER_S * 1e3
    out = dict(shape=shape, max_abs_err=err, ms=ms, host_loop_ms=host_ms,
               plain_ms=plain_ms, plain_host_loop_ms=plain_host_ms,
               bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    if floor_q is not None:
        zeros = torch.empty(floor_q, dtype=torch.int8, device="cuda")
        out["launch_floor_ms"] = time_ms(zeros.zero_)[0]
    return out


#: the relax phase's graphs (``reachbench/configs``), and the pairs of its
#: clean and its dirty batch on each
RELAX_CONFIGS = {"wikitalk": 1024, "lj": 128}
#: edges inserted, then deleted, before the dirty batch
RELAX_UPDATES = 1000


def relax_graph(name, dev):
    """(n, m, Graph with room for the updates, held-out tails, heads) of a
    benchmark configuration's graph, made on the card from seed 0."""
    import torch
    from reachbench.gen import chung_lu, graph_args
    from repro_torch.core.graph import ALIVE, Graph
    cfg = json.loads((ROOT / "reachbench" / "configs" / f"{name}.json")
                     .read_text())
    gr = cfg["graph"]
    n, m = int(gr["n"]), int(gr["m"])
    src, dst = chung_lu(n, m, RELAX_UPDATES, **graph_args(gr), seed=0,
                        device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    s = torch.zeros(m + RELAX_UPDATES, **i32)
    d = torch.zeros(m + RELAX_UPDATES, **i32)
    s[:m], d[:m] = src[:m], dst[:m]
    g = Graph(s, d, torch.tensor(n, **i32), m,
              torch.full((m + RELAX_UPDATES,), ALIVE, **i32))
    return n, m, g, src[m:].cpu().numpy(), dst[m:].cpu().numpy()


def relax_timings(dev, card):
    """The relax kernel on real rounds: for each of ``RELAX_CONFIGS`` a DBL
    index (k = k' = 64) behind a ``ReachabilityServer`` answers a batch of
    random pairs on clean labels, then one on dirty labels after an insert
    and a delete of ``RELAX_UPDATES`` edges.  Every relax step of both
    batches runs the kernel and the plain version on the same operands
    and must agree bitwise (one ``relax_check`` line a graph); the first
    round and the round whose frontier has the most live edges are kept
    and timed by ``timed``.  The bound is the function's compulsory bytes:
    the frontier plane read and the output written (2 n Q), each slot's
    live byte and int64 tail (9 m), and each live slot on the frontier's
    int64 head (8); the kernel's rereads of a tail's row and writes of a
    head's row for each such slot are its gather cost, beyond the bound.
    Returns the timings by name."""
    import torch
    from repro_torch.core.dbl import DBLIndex
    from repro_torch.kernels.bfs_relax import bfs_relax as R
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer
    out = {}
    kernel = R.relax_op
    for name, pairs in RELAX_CONFIGS.items():
        rng = np.random.default_rng(7)
        n, m, g, held_s, held_d = relax_graph(name, dev)
        idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, device=dev)
        srv = ReachabilityServer(None, engine=QueryEngine(
            idx, bfs_chunk=BFS_CHUNK, bfs_kernel=True))
        kept = {}
        rounds = {"clean": 0, "dirty": 0}
        uncut = 0

        def checked(frontier, tails, heads, live, m_cut, n_cap, ftype,
                    batch):
            nonlocal uncut
            got = kernel(frontier, tails, heads, live, m_cut, n_cap, ftype)
            want = R.relax_plain(frontier, tails, heads, live, m_cut, n_cap,
                                 ftype)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"relax_kernel disagrees with its plain version on "
                    f"{name}'s {batch} round {rounds[batch]}")
            rounds[batch] += 1
            uncut += m_cut is None
            if batch != "dirty" or frontier.shape[1] != BFS_CHUNK:
                return got
            # the dirty batch's full chunks are timed, as churn runs them
            edges = int((frontier.any(1)[tails] & live).sum())
            args = (frontier.clone(), tails, heads, live, m_cut, n_cap,
                    ftype)
            if "first" not in kept:
                kept["first"] = (edges, args)
            if edges > kept.get("busiest", (-1,))[0]:
                kept["busiest"] = (edges, args)
            return got
        try:
            for batch in ("clean", "dirty"):
                if batch == "dirty":
                    srv.insert(held_s, held_d)
                    # distinct pairs: each deletes its one slot
                    gone = torch.from_numpy(rng.choice(
                        m, RELAX_UPDATES, replace=False)).to(dev)
                    srv.delete(g.src[gone].cpu().numpy(),
                               g.dst[gone].cpu().numpy())
                R.relax_op = functools.partial(checked, batch=batch)
                srv.query(rng.integers(0, n, pairs),
                          rng.integers(0, n, pairs))
                torch.cuda.synchronize()
        finally:
            R.relax_op = kernel
        if not rounds["dirty"] or uncut:
            raise AssertionError(f"{name}: {rounds} rounds, {uncut} without "
                                 "m_cut: the dirty batch must reach the BFS "
                                 "and every round carry its cutoffs")
        emit("relax_check", graph=name, n=n, m=m, pairs=pairs,
             rounds=rounds, busiest_edges=kept["busiest"][0],
             bitwise=True, card=card)
        del srv, idx
        for which, (edges, args) in kept.items():
            q = args[0].shape[1]
            m_cap = args[1].shape[0]
            nbytes = 2 * n * q + 9 * m_cap + 8 * edges
            out[f"relax_kernel.{name}.{which}"] = dict(
                timed("relax_kernel",
                      f"{name} n_cap={n} m_cap={m_cap} Qc={q} m_cut, "
                      f"{which} round: {edges} frontier edges",
                      lambda a=args: R.relax_op(*a),
                      lambda a=args: R.relax_plain(*a), nbytes,
                      4 * m_cap + edges * q, floor_q=n * q,
                      plain_waits=True),
                frontier_edges=edges)
        del kept
        torch.cuda.empty_cache()
    out["relax_kernel"] = out["relax_kernel.wikitalk.busiest"]
    return out


def ptxas_summary(report):
    """{kernel<tile instance>: [registers, spill store bytes, spill load
    bytes]} from ``_build.ptxas_report``, names cut to the template."""
    out = {}
    for fn, r in report.items():
        short = re.sub(r"\((admit::|verdict::|\(anonymous namespace\)::)"
                       r"Planes.*", "", fn)
        short = re.sub(r"(void )?\(anonymous namespace\)::|admit::|verdict::",
                       "", short)
        out[short] = [r.get("registers"), r.get("spill_stores"),
                      r.get("spill_loads")]
    return out


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
    from repro_torch.kernels.bfs_relax.bfs_relax import bfs_relax
    from repro_torch.kernels.pack_planes.pack_planes import pack_label_planes
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(1)

    dbl_query_verdicts.launches = 0
    bfs_admit_plane.launches = 0
    pack_label_planes.launches = 0
    bfs_relax.launches = 0
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
            packs = pack_label_planes.launches
            srv.insert(ns, nd)
            insert_s = time.perf_counter() - ti
            ans = srv.flush(consistency="as-of-submit")[0]
            query_s = time.perf_counter() - t - insert_s
            mode = "submit-insert-flush"
        else:
            ans = srv.query(u, v)
            query_s = time.perf_counter() - t
            ti = time.perf_counter()
            packs = pack_label_planes.launches
            srv.insert(ns, nd)
            insert_s = time.perf_counter() - ti
            mode = "query-then-insert"
        if pack_label_planes.launches != packs + 1:
            raise AssertionError(f"round {r}: the insert launched the pack "
                                 f"kernel {pack_label_planes.launches - packs}"
                                 " times, not once")
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
                "admit_kernel": bfs_admit_plane.launches,
                "pack_planes_kernel": pack_label_planes.launches,
                "relax_kernel": bfs_relax.launches}
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


def live_edges(g):
    """(src, dst) numpy arrays of the graph's live edges."""
    from repro_torch.core.graph import edge_mask
    live = edge_mask(g)
    return g.src[live].cpu().numpy(), g.dst[live].cpu().numpy()


def dirty_checks(idx, card):
    """On a dirty index: a delta and a full rebuild must give the same
    planes, landmarks and leaf masks, and the device closure ``reach_mask``
    (the delta plan's path on the card) must equal the host's
    ``_host_reach`` on the same inputs, in both directions."""
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core import propagate as P
    from repro_torch.core.dbl import _host_reach
    n_cap = idx.n_cap
    torch.cuda.synchronize()
    t = time.perf_counter()
    d_idx, d_info = idx.rebuild_info(mode="delta", max_iters=64,
                                     check="raise")
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t
    f_idx, f_info = idx.rebuild_info(mode="full", max_iters=64,
                                     check="raise")
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t - delta_s
    for f in ("dl_in", "dl_out", "bl_in", "bl_out", "landmarks",
              "bl_sources", "bl_sinks"):
        if not torch.equal(getattr(d_idx, f), getattr(f_idx, f)):
            raise AssertionError(f"delta and full rebuilds differ in {f}")
    g = idx.graph
    old_live = G.edge_mask(g, idx.label_del_epoch)
    deleted = G.deleted_since(g, idx.label_del_epoch)
    closures = {}
    for name, heads, reverse in (("fwd", g.dst, False), ("bwd", g.src, True)):
        seeds = torch.zeros(n_cap, dtype=torch.bool, device=idx.device)
        seeds[heads[deleted].long()] = True
        torch.cuda.synchronize()
        t = time.perf_counter()
        on_card, iters = P.reach_mask(g.src, g.dst, old_live, seeds,
                                      n_cap=n_cap, max_iters=n_cap,
                                      reverse=reverse)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t) * 1e3
        s, d = (g.dst, g.src) if reverse else (g.src, g.dst)
        t = time.perf_counter()
        on_host = _host_reach(s.cpu().numpy(), d.cpu().numpy(),
                              old_live.cpu().numpy(), seeds.cpu().numpy())
        host_ms = (time.perf_counter() - t) * 1e3
        if not np.array_equal(on_card.cpu().numpy(), on_host):
            raise AssertionError(f"reach_mask ({name}) differs from "
                                 "_host_reach")
        closures[name] = dict(vertices=int(on_host.sum()), iters=iters,
                              reach_mask_ms=card_ms, host_reach_ms=host_ms)
    emit("dirty_checks", card=card, dead_edges=int(G.dead_edge_count(g)),
         delta_rebuild_ms=delta_s * 1e3, full_rebuild_ms=full_s * 1e3,
         delta_info=d_info, full_info=f_info, delta_equals_full=True,
         closures=closures)


def dynamic_phase(dev, card):
    """Fully-dynamic serving on the streamed kernels at full LJ width:
    query -> insert -> delete per round, the lazy rebuild at the third
    round's query.  Returns the kernels' launch counts over the rounds."""
    import torch
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.core import graph as G
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.kernels.bfs_prune.bfs_prune import (
        bfs_admit_plane, bfs_admit_plane_streamed)
    from repro_torch.kernels.dbl_query.dbl_query import (
        dbl_query_verdicts, dbl_query_verdicts_streamed)
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(2)
    t = time.perf_counter()
    g = make_graph(src, dst, n, m_cap=m + N_LJ_ROUNDS * INSERTS, device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, max_iters=64,
                         check="raise", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    # how often the preset repeats a pair: a deleted pair kills every copy
    _, inverse, mult = np.unique(src.astype(np.int64) * n + dst,
                                 return_inverse=True, return_counts=True)
    emit("dynamic_build", n=n, m=m, k=64, k_prime=64, build_s=build_s,
         distinct_pairs=int(mult.size),
         single_slot_pairs=int((mult == 1).sum()),
         mean_copies_of_a_slots_pair=float(mult[inverse].mean()),
         card=card)
    srv = ReachabilityServer(
        index=None, engine=QueryEngine(idx, bfs_chunk=BFS_CHUNK,
                                       max_iters=64, bfs_kernel=True,
                                       streaming=True),
        rebuild_mode="auto", rebuild_dead_ratio=DEAD_RATIO)

    counters = (dbl_query_verdicts_streamed, bfs_admit_plane_streamed,
                dbl_query_verdicts, bfs_admit_plane)
    for f in counters:
        f.launches = 0
    checked = 0
    for r in range(N_LJ_ROUNDS):
        if srv.engine_stats()["rebuild_due"]:
            dirty_checks(srv.index, card)
        u = rng.integers(0, n, QUERIES).astype(np.int32)
        v = rng.integers(0, n, QUERIES).astype(np.int32)
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        es, ed = live_edges(srv.index.graph)   # this round's snapshot
        dirty = srv.dirty
        before = srv.engine.stats.as_dict()
        rebuild_s0 = srv.stats.rebuild_s
        torch.cuda.synchronize()
        t = time.perf_counter()
        ans = srv.query(u, v)            # a due lazy rebuild runs first
        rebuild_s = srv.stats.rebuild_s - rebuild_s0
        query_s = time.perf_counter() - t - rebuild_s
        t = time.perf_counter()
        srv.insert(ns, nd)
        insert_s = time.perf_counter() - t
        # a deleted pair kills every slot that holds it, and the preset's
        # generator repeats pairs (850 000 slots, 24 730 distinct pairs):
        # draw from the pairs that hold one live slot, so that a round
        # tombstones exactly DELETES slots
        ls, ld = live_edges(srv.index.graph)
        pairs, mult = np.unique(ls.astype(np.int64) * n + ld,
                                return_counts=True)
        pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
        ds, dd = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
        t = time.perf_counter()
        srv.delete(ds, dd)
        delete_s = time.perf_counter() - t
        after = srv.engine.stats.as_dict()
        residue = after["prune_hits"]["bfs"] - before["prune_hits"]["bfs"]
        lanes = rng.choice(QUERIES, RANDOM_CHECKS, replace=False)
        reach = host_reach(n, es, ed, np.unique(u[lanes]))
        want = np.array([reach[int(u[i])][v[i]] for i in lanes])
        bad = int((ans[lanes] != want).sum())
        if bad:
            raise AssertionError(f"dynamic round {r}: {bad} of "
                                 f"{lanes.size} checked answers differ from "
                                 "the host BFS over the live edges")
        checked += lanes.size
        emit("dynamic_round", round=r, queries=QUERIES,
             dead_edges=int(G.dead_edge_count(srv.index.graph)),
             dirty_at_query=dirty and not rebuild_s,
             query_ms=query_s * 1e3, qps=QUERIES / query_s,
             rebuild_ms=rebuild_s * 1e3,
             last_rebuild=srv.engine.last_rebuild_info if rebuild_s
             else None,
             insert_ms=insert_s * 1e3, inserts=INSERTS,
             delete_ms=delete_s * 1e3, deletes=DELETES,
             rho=1 - residue / QUERIES, residue_lanes=residue,
             rebuild_due=srv.engine_stats()["rebuild_due"], card=card)
    launches = {"streamed_verdicts_kernel":
                dbl_query_verdicts_streamed.launches,
                "streamed_admit_kernel": bfs_admit_plane_streamed.launches}
    grid = {"verdicts_kernel": dbl_query_verdicts.launches,
            "admit_kernel": bfs_admit_plane.launches}
    emit("dynamic_launches", **launches, grid_kernels=grid,
         rebuilds=srv.stats.rebuilds, delta_rebuilds=srv.stats.delta_rebuilds,
         checked_lanes=checked, mismatches=0)
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched in the dynamic "
                                 "phase")
    if any(grid.values()):
        raise AssertionError(f"the streaming engine launched a grid "
                             f"kernel: {grid}")
    if srv.stats.rebuilds < 1:
        raise AssertionError("the lazy rebuild never ran")
    # a round on the dirty index, through the engine (the server would run
    # its due rebuild first)
    profile_round(srv.engine, rng, n, card, phase="dynamic_profile")
    return launches


def il_packed_phase(dev, card):
    """The "il" family and word planes at full LJ width: the
    ``("dl", "bl", "il")`` index built with ``plane_repr="packed"`` and
    served by a packed engine (``frontier_dtype="packed"``, int32 verdict
    stores) behind a ``ReachabilityServer``, beside a default index and
    engine on the same stream.  Checks the build against the bool build
    and the CPU build, every answer against the default engine's and the
    checked ones against a host BFS, the "il" column on a dirty round, the
    lazy rebuild's planes against a fresh build's, and the streaming
    engine's fallback to the grid verdict kernel.  Returns the kernels'
    launch counts over its served rounds."""
    import warnings

    import torch
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.core import graph as G
    from repro_torch.core import interval as IL
    from repro_torch.core import labels as L
    from repro_torch.core import select as S
    from repro_torch.core.query import (PackedLabels, il_violation_plane,
                                        label_verdicts)
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.kernels.bfs_prune.bfs_prune import (
        bfs_admit_plane, bfs_admit_plane_streamed)
    from repro_torch.kernels.dbl_query.dbl_query import (
        dbl_query_verdicts, dbl_query_verdicts_streamed)
    from repro_torch.kernels.dbl_query.ops import StreamILFallbackWarning
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    # every served round inserts a batch: four, two delete rounds and one
    # after the rebuild
    m_cap = m + (N_IL_ROUNDS + 3) * INSERTS
    rng = np.random.default_rng(3)
    kw = dict(n_cap=n, k=64, k_prime=64, max_iters=64, check="raise",
              device=dev)

    def graph():
        return make_graph(src, dst, n, m_cap=m_cap, device=dev)

    def timed_build(**extra):
        g = graph()
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = DBLIndex.build(g, **kw, **extra)
        torch.cuda.synchronize()
        return idx, time.perf_counter() - t

    base, bool_s = timed_build()
    idx, il_s = timed_build(plane_repr="packed", **IL_FAM)
    for f in ("dl_in", "dl_out", "bl_in", "bl_out", "landmarks"):
        if not torch.equal(getattr(idx, f), getattr(base, f)):
            raise AssertionError(f"il+packed build differs from the bool "
                                 f"build in {f}")
    g_cpu = make_graph(src, dst, n, m_cap=m_cap, device="cpu")
    cpu_in, cpu_out, _ = IL.build_il(g_cpu, n_cap=n, dim=IL_FAM["il_dim"],
                                     seed=IL_FAM["il_seed"], max_iters=64)
    if not (torch.equal(idx.il_in.cpu(), cpu_in)
            and torch.equal(idx.il_out.cpu(), cpu_out)):
        raise AssertionError("il planes on the card differ from the CPU "
                             "build's")
    # the six fixpoints' round counts, by the build's own steps
    g = graph()
    lm = S.select_landmarks(g, n_cap=n, k=64)
    sources, sinks = S.leaf_masks(g, n_cap=n)
    iters = (L.build_dl(g, lm, n_cap=n, k=64, max_iters=64,
                        plane_repr="packed")[2]
             + L.build_bl(g, sources, sinks, n_cap=n, k_prime=64,
                          max_iters=64, plane_repr="packed")[2]
             + IL.build_il(g, n_cap=n, dim=IL_FAM["il_dim"],
                           seed=IL_FAM["il_seed"], max_iters=64)[2])
    if max(iters) > 64:
        raise AssertionError(f"a fixpoint saturated: {iters}")
    emit("il_packed_build", n=n, m=m, k=64, k_prime=64, **IL_FAM,
         iters_dl_bl_il=iters, build_s=il_s, bool_build_s=bool_s,
         il_equals_cpu=True, dl_bl_equal_bool=True, card=card)

    engine_kw = dict(bfs_chunk=BFS_CHUNK, max_iters=64, bfs_kernel=True)
    srvs = {
        "il_packed": ReachabilityServer(
            None, engine=QueryEngine(idx, plane_repr="packed",
                                     frontier_dtype="packed",
                                     out_dtype="int32", **engine_kw),
            rebuild_mode="auto", rebuild_dead_ratio=DEAD_RATIO),
        "default": ReachabilityServer(
            None, engine=QueryEngine(base, **engine_kw),
            rebuild_mode="auto", rebuild_dead_ratio=DEAD_RATIO)}
    counters = (dbl_query_verdicts, bfs_admit_plane,
                dbl_query_verdicts_streamed, bfs_admit_plane_streamed)
    for f in counters:
        f.launches = 0
    checked = 0

    def served_round(r, mode):
        """One round on both servers: queries (pipelined across the
        insert in "submit-insert-flush"), 100 inserts, then ``mode``'s
        deletes; answers held against each other and a host BFS."""
        nonlocal checked
        u = rng.integers(0, n, QUERIES).astype(np.int32)
        v = rng.integers(0, n, QUERIES).astype(np.int32)
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        snap = srvs["il_packed"].index
        es, ed = live_edges(snap.graph)
        words = PackedLabels(*(w.clone() for w in snap.packed))
        il = tuple(x.clone() for x in snap.il)
        dirty = snap.is_dirty
        out = {}
        for name, srv in srvs.items():
            before = srv.engine.stats.as_dict()["prune_hits"]
            rebuild_s0 = srv.stats.rebuild_s
            torch.cuda.synchronize()
            t = time.perf_counter()
            if mode == "submit-insert-flush":
                srv.submit(u, v)
                ti = time.perf_counter()
                srv.insert(ns, nd)
                insert_s = time.perf_counter() - ti
                ans = srv.flush(consistency="as-of-submit")[0]
                query_s = time.perf_counter() - t - insert_s
            else:
                ans = srv.query(u, v)
                query_s = time.perf_counter() - t
                ti = time.perf_counter()
                srv.insert(ns, nd)
                insert_s = time.perf_counter() - ti
            rebuild_s = srv.stats.rebuild_s - rebuild_s0
            after = srv.engine.stats.as_dict()["prune_hits"]
            hits = {k: after[k] - before[k] for k in after}
            out[name] = dict(ans=ans, hits=hits, query_ms=(
                query_s - rebuild_s) * 1e3, insert_ms=insert_s * 1e3,
                rebuild_ms=rebuild_s * 1e3,
                rho=1 - hits["bfs"] / QUERIES)
        a, b = out["il_packed"], out["default"]
        if not np.array_equal(a["ans"], b["ans"]):
            raise AssertionError(f"il_packed round {r}: answers differ "
                                 "from the default engine's")
        if dirty and not a["rebuild_ms"] and a["hits"]["il"]:
            raise AssertionError(f"il_packed round {r}: {a['hits']['il']} "
                                 "il hits on dirty labels")
        lanes = rng.choice(QUERIES, RANDOM_CHECKS, replace=False)
        if not dirty:
            # the residue by the snapshot's labels, in plain torch ops
            verd = label_verdicts(words, torch.from_numpy(u).to(dev),
                                  torch.from_numpy(v).to(dev), il=il)
            res = np.flatnonzero(verd.cpu().numpy() == -1)
            if res.size != a["hits"]["bfs"]:
                raise AssertionError(
                    f"il_packed round {r}: {res.size} unknown lanes by the "
                    f"labels, the engine ran {a['hits']['bfs']}")
            lanes = np.union1d(lanes, res)
        reach = host_reach(n, es, ed, np.unique(u[lanes]))
        want = np.array([reach[int(u[i])][v[i]] for i in lanes])
        bad = int((a["ans"][lanes] != want).sum())
        if bad:
            raise AssertionError(f"il_packed round {r}: {bad} of "
                                 f"{lanes.size} checked answers differ from "
                                 "the host BFS")
        checked += lanes.size
        deletes = 0
        if mode == "delete":
            ls, ld = live_edges(srvs["il_packed"].index.graph)
            pairs, mult = np.unique(ls.astype(np.int64) * n + ld,
                                    return_counts=True)
            pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
            ds, dd = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
            for name, srv in srvs.items():
                t = time.perf_counter()
                srv.delete(ds, dd)
                out[name]["delete_ms"] = (time.perf_counter() - t) * 1e3
            deletes = DELETES
        emit("il_packed_round", round=r, mode=mode, queries=QUERIES,
             inserts=INSERTS, deletes=deletes, dirty_at_query=dirty and not
             a["rebuild_ms"], last_rebuild=srvs["il_packed"].engine
             .last_rebuild_info if a["rebuild_ms"] else None,
             **{name: {k: x for k, x in o.items() if k != "ans"}
                for name, o in out.items()}, card=card)

    def streaming_check():
        """A streaming engine on the (dirty) "il" index: one warning, the
        grid verdict kernel, the streamed admit kernel for the residue,
        answers equal to the packed engine's.  Its launches are counted
        from 0; its grid verdict launches add to the phase's, and its
        streamed admit launches are returned."""
        saved = [f.launches for f in counters]
        for f in counters:
            f.launches = 0
        eng = QueryEngine(srvs["il_packed"].index, streaming=True,
                          plane_repr="packed", frontier_dtype="packed",
                          out_dtype="int32", **engine_kw)
        u = rng.integers(0, n, QUERIES).astype(np.int32)
        v = rng.integers(0, n, QUERIES).astype(np.int32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = [eng.query(u, v), eng.query(v, u)]
        warned = sum(issubclass(w.category, StreamILFallbackWarning)
                     for w in caught)
        stream = {"streamed_verdicts_kernel":
                  dbl_query_verdicts_streamed.launches,
                  "streamed_admit_kernel": bfs_admit_plane_streamed.launches,
                  "verdicts_kernel": dbl_query_verdicts.launches,
                  "admit_kernel": bfs_admit_plane.launches}
        # the grid kernels' launches join the phase's count; the streamed
        # counters go back to what the grid engines left them at
        for f, c in zip(counters, saved):
            f.launches = c + (f.launches if f in counters[:2] else 0)
        emit("il_packed_streaming", warnings=warned, launches=stream,
             residue_lanes=eng.stats.prune_hits["bfs"], card=card)
        if warned != 1:
            raise AssertionError(f"the streaming engine warned {warned} "
                                 "times")
        if stream["streamed_verdicts_kernel"] or stream["admit_kernel"] \
                or not stream["streamed_admit_kernel"] \
                or not stream["verdicts_kernel"]:
            raise AssertionError(f"streaming il launches: {stream}")
        want = [srvs["il_packed"].engine.query(u, v),
                srvs["il_packed"].engine.query(v, u)]
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the streaming engine's answers differ")
        return stream["streamed_admit_kernel"]

    for r in range(N_IL_ROUNDS):
        served_round(r, "submit-insert-flush" if r == 2 else
                     "query-then-insert")
    # a round that deletes 500 single-slot pairs (below the tombstone
    # ratio), then a dirty round that deletes 500 more (the ratio trips);
    # the lazy rebuild runs at the next flush boundary.  The streaming
    # engine runs on the dirty index, where the residue is not empty.
    served_round(N_IL_ROUNDS, "delete")
    streamed_admit = streaming_check()
    # a dirty query batch under the profiler, without the insert that
    # would set the two servers apart
    profile_round(srvs["il_packed"].engine, rng, n, card,
                  phase="il_packed_dirty_profile", insert=False)
    served_round(N_IL_ROUNDS + 1, "delete")
    srv = srvs["il_packed"]
    if not srv.engine_stats()["rebuild_due"]:
        raise AssertionError("the lazy rebuild is not due after two "
                             "delete rounds")
    g_due = srv.index.graph
    rebuild_ms = {}
    for name, s_ in srvs.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s_.flush()
        rebuild_ms[name] = (time.perf_counter() - t) * 1e3
        if s_.stats.rebuilds != 1:
            raise AssertionError(f"{name}: the lazy rebuild did not run")
    fresh = DBLIndex.build(G.compact(g_due), plane_repr="packed", **kw,
                           **IL_FAM)
    for f in ("il_in", "il_out", "dl_in", "dl_out", "bl_in", "bl_out",
              "landmarks"):
        if not torch.equal(getattr(srv.index, f), getattr(fresh, f)):
            raise AssertionError(f"the lazy rebuild's {f} differs from a "
                                 "fresh build's")
    emit("il_packed_rebuild", rebuild_ms=rebuild_ms,
         info=srv.engine.last_rebuild_info,
         default_info=srvs["default"].engine.last_rebuild_info,
         equals_fresh_build=True, card=card)
    served_round(N_IL_ROUNDS + 2, "query-then-insert")
    launches = {"verdicts_kernel": dbl_query_verdicts.launches,
                "admit_kernel": bfs_admit_plane.launches}
    streamed = {"streamed_verdicts_kernel":
                dbl_query_verdicts_streamed.launches,
                "streamed_admit_kernel": bfs_admit_plane_streamed.launches}
    emit("il_packed_launches", **launches, streamed_kernels=streamed,
         checked_lanes=checked, mismatches=0)
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched in the il_packed "
                                 "phase")
    if any(streamed.values()):
        raise AssertionError(f"the grid engines launched a streamed "
                             f"kernel: {streamed}")
    launches["streamed_admit_kernel"] = streamed_admit

    # the interval AND at the coalesced phase's chunk, alone and with the
    # admit plane it gates
    il = srv.index.il
    q = CHUNK_QS[-1]
    vv = torch.from_numpy(rng.integers(0, n, q).astype(np.int32)).to(dev)
    admit = torch.ones((n, q), dtype=torch.int8, device=dev)
    and_ms = time_ms(lambda: (admit > 0) & ~il_violation_plane(il, vv))[0]
    plane_ms = time_ms(lambda: il_violation_plane(il, vv))[0]
    emit("il_and", shape=f"n_cap={n} dim={IL_FAM['il_dim']} Qc={q}",
         il_violation_plane_ms=plane_ms, and_ms=and_ms,
         bool_bytes=n * q * 2 * IL_FAM["il_dim"], card=card)
    profile_round(srv, rng, n, card, phase="il_packed_profile")
    return launches


def _host_time(fn):
    """(fn(), ms) on the host clock alone: a run on the CPU."""
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _replicated_rounds(kind, idx, prev=None, ns=None, nd=None):
    """The replicated port's fixpoint rounds for one lifecycle step, in
    the sharded order (fused fwd, fused bwd, il in, il out).  A fused
    direction runs as long as its slower family, so its rounds are the
    larger of the DL and BL fixpoints'."""
    from repro_torch.core import graph as G
    from repro_torch.core import interval as IL
    from repro_torch.core import labels as L
    from repro_torch.core import propagate as P
    from repro_torch.core import update as U
    n = idx.n_cap
    if kind == "build":
        dl = L.build_dl(idx.graph, idx.landmarks, n_cap=n, k=idx.k,
                        max_iters=64)[2]
        bl = L.build_bl(idx.graph, idx.bl_sources, idx.bl_sinks, n_cap=n,
                        k_prime=idx.k_prime, max_iters=64)[2]
        rounds = [max(dl[0], bl[0]), max(dl[1], bl[1])]
        if idx.il_in is not None:
            rounds += IL.build_il(idx.graph, n_cap=n, dim=idx.il_dim,
                                  seed=idx.il_seed, max_iters=64)[2]
        return rounds
    if kind == "insert":
        it = U.insert_and_update(prev.graph, prev.dl_in, prev.dl_out,
                                 prev.bl_in, prev.bl_out, ns, nd,
                                 prev.epoch, n_cap=n, max_iters=64)[5]
        rounds = [max(it[0], it[2]), max(it[1], it[3])]
        if prev.il_in is not None:
            rounds += IL.insert_update_il(idx.graph, prev.il_in,
                                          prev.il_out, ns, nd, n_cap=n,
                                          max_iters=64)[2]
        return rounds
    # the delta repair: the fused fixpoints over the whole live edge set
    dp = prev._delta_plan(selection="product", leaf_r=0)
    g = prev.graph
    st = L.delta_plane_state(
        g, prev.dl_in, prev.dl_out, prev.bl_in, prev.bl_out,
        prev.landmarks, dp["landmarks"], prev.bl_sources, prev.bl_sinks,
        dp["sources"], dp["sinks"], dp["dirty_fwd"], dp["dirty_bwd"],
        n_cap=n, k=prev.k, k_prime=prev.k_prime)
    live = G.edge_mask(g)
    rounds = []
    for rev, x, fresh, seed, fr in ((False, st[0], st[2], st[4], st[6]),
                                    (True, st[1], st[3], st[5], st[7])):
        fr = fr | (seed.bool() & fresh[None, :]).any(1)
        rounds.append(P.propagate(x, g.src, g.dst, live, fr, n_cap=n,
                                  max_iters=64, reverse=rev)[1])
    if idx.il_in is not None:
        rounds += IL.build_il(idx.graph, n_cap=n, dim=idx.il_dim,
                              seed=idx.il_seed, max_iters=64)[2]
    return rounds


def _hold_shard(step, mesh, shard, rep, rounds, want_rounds, info=None,
                want_info=None):
    """The shard's row block and whole fields against the replicated
    index, bit for bit; raises on the first difference."""
    import torch
    from repro_torch.core import planes as PL
    n_loc = rep.n_cap // mesh.size
    rows = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)
    pairs = [(f, getattr(shard, f), getattr(rep, f)[rows])
             for f in ("dl_in", "dl_out", "bl_in", "bl_out")]
    pairs += [(f"packed.{f}", getattr(shard.packed, f),
               getattr(rep.packed, f)[rows])
              for f in ("dl_in", "dl_out", "bl_in", "bl_out")]
    if rep.il_in is not None:
        pairs += [(f, getattr(shard, f), getattr(rep, f)[rows])
                  for f in ("il_in", "il_out")]
    pairs += [(f, getattr(shard, f), getattr(rep, f))
              for f in ("landmarks", "bl_sources", "bl_sinks")]
    for f, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"sharded {step}: {f} differs from the "
                                 f"replicated port's (rank {mesh.rank})")
    same = {"saturated": (shard.saturated, rep.saturated),
            "m": (shard.graph.m, rep.graph.m),
            "epoch": (shard.epoch, rep.epoch),
            "rounds": ([int(r) for r in rounds],
                       [int(r) for r in want_rounds]),
            "info": (info, want_info),
            "bytes": (PL.per_device_label_bytes(shard) * mesh.size,
                      PL.per_device_label_bytes(rep))}
    for f, (a, b) in same.items():
        if a != b:
            raise AssertionError(f"sharded {step}: {f} {a} != replicated "
                                 f"{b} (rank {mesh.rank})")
    return [int(r) for r in rounds]


class _Collectives:
    """Counts the ``torch.distributed`` calls of a sharded path
    (``all_reduce`` and ``all_to_all_single`` with the bytes of the tensor
    each sends) and the residue chunks (``planes.sharded_pruned_bfs``
    calls) while installed; an all-gather raises, unless ``gather`` (the
    query mesh's label phase) counts it, and a broadcast always does."""

    COUNTED = ("all_reduce", "all_to_all_single")
    GATHERS = ("all_gather", "all_gather_into_tensor", "all_gather_single")

    def __init__(self, gather: bool = False):
        self.gather = gather
        self.n = dict.fromkeys(self.COUNTED + ("bfs_chunks",
                                               "all_reduce_bytes",
                                               "all_to_all_single_bytes",
                                               "gathers"), 0)
        self.saved = {}

    def __enter__(self):
        import torch.distributed as dist
        from repro_torch.core import planes as PL

        def counted(name, fn):
            def call(*a, **kw):
                self.n[name] += 1
                if name in self.COUNTED:
                    sent = a[0] if name == "all_reduce" else a[1]
                    self.n[f"{name}_bytes"] += \
                        sent.numel() * sent.element_size()
                return fn(*a, **kw)
            return call

        def forbidden(name):
            def call(*a, **kw):
                raise AssertionError(f"{name} on a sharded path")
            return call

        names = [n for n in self.COUNTED + self.GATHERS + ("broadcast",)
                 if hasattr(dist, n)]
        for name in names:
            fn = getattr(dist, name)
            self.saved[(dist, name)] = fn
            if name in self.COUNTED:
                wrapped = counted(name, fn)
            elif name in self.GATHERS and self.gather:
                wrapped = counted("gathers", fn)
            else:
                wrapped = forbidden(name)
            setattr(dist, name, wrapped)
        self.saved[(PL, "sharded_pruned_bfs")] = PL.sharded_pruned_bfs
        PL.sharded_pruned_bfs = counted("bfs_chunks", PL.sharded_pruned_bfs)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)

    def take(self) -> dict:
        """The counts since the last ``take``."""
        out, self.n = self.n, dict.fromkeys(self.n, 0)
        return out


def _residue_lanes(snap, u, v):
    """The lanes the snapshot's labels leave unknown (plain torch ops):
    all four rules on clean labels, self-queries and BL negatives only on
    dirty ones."""
    import torch
    from repro_torch.core import query as Q
    uu = torch.from_numpy(u).to(snap.device)
    vv = torch.from_numpy(v).to(snap.device)
    if snap.is_dirty:
        verd = Q.cut_verdicts(snap.packed, uu, vv, 1, 0, False)
    else:
        verd = Q.label_verdicts(snap.packed, uu, vv, il=snap.il)
    return np.flatnonzero(verd.cpu().numpy() == -1)


def sharded_serve(mesh, extra, profile_card=None):
    """Serving on this rank's shard: a ``ReachabilityServer`` over
    ``QueryEngine(vertex_mesh=mesh)`` beside a replicated server on the
    same card, both on the LJ preset at full width.  Two rounds of QUERIES
    queries and INSERTS inserts (the second through submit -> insert ->
    flush), a delete of DELETES single-slot pairs, a dirty round, the
    engine's delta rebuild and a clean round.  Every answer equals the
    replicated server's; on rank 0 the residue lanes and RANDOM_CHECKS
    random lanes a round equal a host BFS over the round's live edges.
    ``profile_card`` (the world of one) adds a profiled round on the
    sharded server.  Returns the rounds' times and counts."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    dev = mesh.device
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(7)
    kw = dict(n_cap=n, k=64, k_prime=64, max_iters=64, check="raise",
              device=dev, **extra)
    eng_kw = dict(bfs_chunk=BFS_CHUNK, max_iters=64,
                  plane_repr=extra.get("plane_repr", "bool"))
    m_cap = m + (SHARDED_SERVE_ROUNDS + 1) * INSERTS

    def server(**vertex):
        # each server its own graph and index: the replicated engine
        # rewrites its planes in place on insert (donation)
        g = make_graph(src, dst, n, m_cap=m_cap, device=dev)
        idx = DBLIndex.build(g, **kw)
        return ReachabilityServer(
            None, engine=QueryEngine(idx, **vertex, **eng_kw),
            rebuild_dead_ratio=None)

    srvs = {"sharded": server(vertex_mesh=mesh), "replicated": server()}
    sh = srvs["sharded"].index
    row_words = sum(w.shape[1] for w in sh.packed) * 2
    il_words = 0 if sh.il is None else 4 * sh.il_in.shape[1]
    out = {"rounds": [], "row_all_reduce_bytes": LABEL_Q * row_words * 4,
           "il_all_reduce_bytes": LABEL_Q * il_words * 4}
    counts = _Collectives()

    def served_round(r, mode):
        u = rng.integers(0, n, QUERIES).astype(np.int32)
        v = rng.integers(0, n, QUERIES).astype(np.int32)
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        snap = srvs["replicated"].index
        es, ed = live_edges(snap.graph)
        lanes = _residue_lanes(snap, u, v)
        line = {"round": r, "mode": mode, "dirty": snap.is_dirty}
        answers = {}
        for name, srv in srvs.items():
            before = srv.engine.stats.as_dict()["prune_hits"]["bfs"]
            counts.take()
            q_ms = i_ms = 0.0
            if mode == "submit-insert-flush":
                _, q_ms = _sync_time(lambda: srv.submit(u, v))
                label = counts.take()
                if name == "sharded":
                    # the label phase's row blocks, read off the counter
                    line["label_all_reduce_bytes"] = \
                        label["all_reduce_bytes"]
                    want = out["row_all_reduce_bytes"] \
                        + out["il_all_reduce_bytes"]
                    if label["all_reduce_bytes"] != want:
                        raise AssertionError(
                            f"sharded label phase all_reduce moved "
                            f"{label['all_reduce_bytes']} B, not {want}")
                _, i_ms = _sync_time(lambda: srv.insert(ns, nd))
                counts.take()
                ans, f_ms = _sync_time(
                    lambda: srv.flush(consistency="as-of-submit")[0])
                q_ms += f_ms
                query = {k: c + label[k]
                         for k, c in counts.take().items()}
            else:
                ans, q_ms = _sync_time(lambda: srv.query(u, v))
                query = counts.take()
                if mode == "query-then-insert":
                    _, i_ms = _sync_time(lambda: srv.insert(ns, nd))
            residue = srv.engine.stats.as_dict()["prune_hits"]["bfs"] \
                - before
            answers[name] = ans
            line[name] = {"query_ms": q_ms, "insert_ms": i_ms,
                          "residue_lanes": residue,
                          "rho": 1 - residue / QUERIES}
            if name == "sharded":
                chunks, a2a = query["bfs_chunks"], query["all_to_all_single"]
                # all_reduce calls that are not a BFS round's: the row
                # blocks (one, two with il) of the label phase and of each
                # chunk's re-check, and each chunk's first frontier count
                fixed = (1 + chunks) * (2 if il_words else 1) + chunks
                line[name].update(
                    bfs_chunks=chunks, bfs_rounds=a2a,
                    bfs_rounds_per_chunk=a2a / chunks if chunks else 0,
                    collectives=query,
                    all_reduce_per_bfs_round=(query["all_reduce"] - fixed)
                    / a2a if a2a else 0)
            if residue != lanes.size:
                raise AssertionError(
                    f"sharded serve round {r} ({name}): {lanes.size} "
                    f"unknown lanes by the labels, the engine ran "
                    f"{residue}")
        if not np.array_equal(answers["sharded"], answers["replicated"]):
            raise AssertionError(f"sharded serve round {r}: answers differ "
                                 "from the replicated server's")
        # every rank draws the random lanes, so the ranks' streams stay
        # the same; rank 0 checks them
        lanes = np.union1d(lanes, rng.choice(QUERIES, RANDOM_CHECKS,
                                             replace=False))
        bad = torch.zeros(1, dtype=torch.int64, device=dev)
        if mesh.rank == 0:
            reach = host_reach(n, es, ed, np.unique(u[lanes]))
            want = np.array([reach[int(u[i])][v[i]] for i in lanes])
            bad += int((answers["sharded"][lanes] != want).sum())
            line["host_checked_lanes"] = int(lanes.size)
        # every rank waits here for rank 0's check (and fails with it), so
        # no rank's next timed call includes that wait
        dist.all_reduce(bad, group=mesh.group)
        counts.take()
        if int(bad):
            raise AssertionError(f"sharded serve round {r}: {int(bad)} of "
                                 f"{lanes.size} checked answers differ "
                                 "from the host BFS")
        out["rounds"].append(line)

    with counts:
        served_round(0, "query-then-insert")
        served_round(1, "submit-insert-flush")
        ls, ld = live_edges(srvs["replicated"].index.graph)
        pairs, mult = np.unique(ls.astype(np.int64) * n + ld,
                                return_counts=True)
        pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
        ds, dd = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
        out["delete_ms"] = {name: _sync_time(lambda: srv.delete(ds, dd))[1]
                            for name, srv in srvs.items()}
        out["delete_collectives"] = counts.take()
        served_round(2, "dirty")
        out["rebuild_ms"] = {
            name: _sync_time(lambda: srv.rebuild(mode="delta"))[1]
            for name, srv in srvs.items()}
        out["rebuild_collectives"] = counts.take()
        infos = [srv.engine.last_rebuild_info for srv in srvs.values()]
        if infos[0] != infos[1]:
            raise AssertionError(f"sharded serve rebuild info {infos}")
        out["rebuild_info"] = infos[0]
        served_round(3, "clean")
    stats = [srv.engine.stats.as_dict() for srv in srvs.values()]
    if stats[0] != stats[1]:
        raise AssertionError(f"sharded serve engine stats differ: {stats}")
    out["engine_stats"] = stats[0]
    if profile_card is not None:
        profile_round(srvs["sharded"], rng, n, profile_card,
                      phase="sharded_serve_profile")
    return out


def sharded_lifecycle(mesh, extra, profile_card=None):
    """The LJ lifecycle on this rank's shard beside the replicated port on
    the same card: build, SHARDED_INSERTS inserts, a delete of DELETES
    single-slot pairs, the delta and the full rebuild.  Each step runs
    twice on the shard, with the dense halo and with the sparse one
    (SPARSE_HALO), and both are held bit for bit (``_hold_shard``): the
    sparse shard's rounds equal the dense one's.  Each mode has its own
    halo telemetry and its own count of the collectives' calls and bytes.
    Then the serving stream (:func:`sharded_serve`).  Returns the steps'
    times (ms, dense, sparse and replicated), rounds, the delta rebuild's
    info, the halo accounting under "halo" and the stream's results under
    "serve"."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.core import distributed as D
    from repro_torch.core import halo as HL
    from repro_torch.core import planes as PL
    from repro_torch.graphs.generators import table2_graph

    dev = mesh.device
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(5)
    g = make_graph(src, dst, n, m_cap=m + SHARDED_INSERTS * INSERTS,
                   device=dev)
    kw = dict(max_iters=64, check="raise")
    pr = {k: v for k, v in extra.items() if k == "plane_repr"}
    out = {"ms": {}, "sparse_ms": {}, "replicated_ms": {}, "rounds": {}}
    tel = {"dense": HL.HaloTelemetry(), "sparse": HL.HaloTelemetry()}
    wire = {"dense": _Collectives(), "sparse": _Collectives()}
    halo = {"dense": dict(telemetry=tel["dense"]),
            "sparse": dict(halo_mode="sparse", telemetry=tel["sparse"])}

    def step(name, shard_fn, rep_fn):
        """``shard_fn(mode, rounds)`` for both modes, in turns (dense
        first on every other step), then ``rep_fn``.  Every rank waits
        for the others before each timed call, so no rank times its
        peers' untimed replicated work."""
        res = {}
        modes = (("dense", "ms"), ("sparse", "sparse_ms"))
        for mode, key in modes[::1 if len(out["ms"]) % 2 == 0 else -1]:
            rounds = []
            dist.all_reduce(torch.zeros(1, device=dev), group=mesh.group)
            with wire[mode]:
                shard, out[key][name] = _sync_time(
                    lambda: shard_fn(mode, rounds))
            res[mode] = (shard, rounds)
        rep, out["replicated_ms"][name] = _sync_time(rep_fn)
        return res, rep

    def hold(name, res, rep, want_rounds, want_info=None):
        """Both modes against the replicated index; their rounds."""
        got = {}
        for mode, (shard, rounds) in res.items():
            info = shard[2] if want_info is not None else None
            got[mode] = _hold_shard(f"{name} ({mode} halo)", mesh, shard[0],
                                    rep, rounds, want_rounds, info,
                                    want_info)
        return got["dense"]

    def build(mode, r):
        hub = {"hub_count": SPARSE_HALO["hub_count"]} \
            if mode == "sparse" else {}
        return D.build_vertex_sharded(g, mesh, n_cap=n, k=64, k_prime=64,
                                      rounds=r, **kw, **extra, **hub,
                                      **halo[mode])

    res, rep = step("build", build,
                    lambda: DBLIndex.build(g, n_cap=n, k=64, k_prime=64,
                                           device=dev, **kw, **extra))
    out["rounds"]["build"] = hold("build", res, rep,
                                  _replicated_rounds("build", rep))
    state = {mode: res[mode][0] for mode in res}     # (shard, plan)
    plan = state["dense"][1]
    # the host's share of a build: the plan alone (both directions'
    # tables built with numpy and this rank's rows uploaded)
    _, out["plan_ms"] = _sync_time(
        lambda: PL.shard_plan(g.src, g.dst, g.m, n, mesh))
    out["extend_ms"] = []
    out["halo_rows"] = [int(plan.fwd.h_send.shape[1]),
                        int(plan.bwd.h_send.shape[1])]
    out["fwd_bucket_edges"] = int(plan.fwd.e_valid.sum())
    out["label_bytes"] = [PL.per_device_label_bytes(state["dense"][0]),
                          PL.per_device_label_bytes(rep)]
    for b in range(SHARDED_INSERTS):
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        prev = rep
        out["extend_ms"].append(
            _sync_time(lambda: PL.extend_plan(plan, ns, nd))[1])
        res, rep = step(
            f"insert{b}",
            lambda mode, r: D.insert_vertex_sharded(
                *state[mode], ns, nd, rounds=r, **kw, **pr, **halo[mode]),
            lambda: prev.insert_edges(ns, nd, **kw, **pr))
        out["rounds"][f"insert{b}"] = hold(
            f"insert{b}", res, rep,
            _replicated_rounds("insert", rep, prev, torch.from_numpy(ns)
                               .to(dev), torch.from_numpy(nd).to(dev)))
        state = {mode: res[mode][0][:2] for mode in res}
        plan = state["dense"][1]
    ls, ld = live_edges(rep.graph)
    pairs, mult = np.unique(ls.astype(np.int64) * n + ld,
                            return_counts=True)
    pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
    ds, dd = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
    state = {mode: (sh.delete_edges(ds, dd), pl)
             for mode, (sh, pl) in state.items()}
    rep = rep.delete_edges(ds, dd)
    for mode in state:
        _hold_shard(f"delete ({mode} halo)", mesh, state[mode][0], rep, [],
                    [])
    for rmode in ("delta", "full"):
        res, (r2, want) = step(
            rmode,
            lambda mode, r: D.rebuild_vertex_sharded(
                *state[mode], mode=rmode, rounds=r, **kw, **pr,
                **halo[mode]),
            lambda: rep.rebuild_info(mode=rmode, **kw, **pr))
        kind = "delta" if want["mode"] == "delta" else "build"
        out["rounds"][rmode] = hold(rmode, res, r2,
                                    _replicated_rounds(kind, r2, rep), want)
        if rmode == "delta":
            out["delta_info"] = res["dense"][0][2]
    out["halo"] = {mode: {"telemetry": tel[mode].as_dict(),
                          "wire": {k: c for k, c in wire[mode].n.items()
                                   if k not in ("bfs_chunks", "gathers")}}
                   for mode in tel}
    td = out["halo"]["dense"]["telemetry"]
    ts = out["halo"]["sparse"]["telemetry"]
    if ts["halo_rounds"] != td["halo_rounds"] \
            or ts["fixpoints"] != td["fixpoints"]:
        raise AssertionError(f"sparse halo rounds {ts} != dense {td}")
    if mesh.size == 1 and (ts["local_rounds"] != ts["halo_rounds"]
                           or out["halo"]["sparse"]["wire"]
                           ["all_to_all_single"]):
        raise AssertionError("a world of one has no pairs: its sparse "
                             f"rounds must all be local, not {ts}, "
                             f"{out['halo']['sparse']['wire']}")
    out["serve"] = sharded_serve(mesh, extra, profile_card)
    return out


def query_mesh_serve(mesh):
    """``ReachabilityServer(mesh=query mesh)`` over ``QueryEngine(
    bfs_kernel=True)`` beside a replicated server on the same card, both
    on the LJ preset at full width: a round of QUERIES queries then INSERTS
    inserts, a submit -> insert -> flush round, a delete of DELETES
    single-slot pairs, a dirty round, the delta rebuild and a clean round.
    Every answer and the engine stats equal the replicated server's; each
    label phase on the mesh issues one all-gather and no other collective.
    The kernels' launches are counted over the mesh server's calls only
    (each counter set to 0 just before a call and read just after).
    Returns the rounds' times, the collectives and the launches."""
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.kernels.bfs_prune.bfs_prune import bfs_admit_plane
    from repro_torch.kernels.dbl_query.dbl_query import dbl_query_verdicts
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    dev = mesh.device
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(9)

    def server(**layout):
        # each server its own graph and index: the replicated engine
        # rewrites its planes in place on insert (donation)
        g = make_graph(src, dst, n, m_cap=m + 3 * INSERTS, device=dev)
        idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, max_iters=64,
                             check="raise", device=dev)
        return ReachabilityServer(None, engine=QueryEngine(
            idx, bfs_chunk=BFS_CHUNK, max_iters=64, bfs_kernel=True,
            **layout), rebuild_dead_ratio=None)

    srvs = {"mesh": server(mesh=mesh), "replicated": server()}
    counters = {"verdicts_kernel": dbl_query_verdicts,
                "admit_kernel": bfs_admit_plane}
    launches = dict.fromkeys(counters, 0)
    counts = _Collectives(gather=True)
    out = {"lanes_per_rank": -(-LABEL_Q // mesh.size), "rounds": []}

    def call(name, fn):
        """(result, ms) of ``fn(server)``; on the mesh server with its
        launches and collectives counted."""
        srv = srvs[name]
        if name != "mesh":
            return _sync_time(lambda: fn(srv))
        for k in counters.values():
            k.launches = 0
        with counts:
            res = _sync_time(lambda: fn(srv))
        for name_, k in counters.items():
            launches[name_] += k.launches
        return res

    def served_round(r, mode):
        u = rng.integers(0, n, QUERIES).astype(np.int32)
        v = rng.integers(0, n, QUERIES).astype(np.int32)
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        line = {"round": r, "mode": mode,
                "dirty": srvs["replicated"].dirty}
        answers = {}
        counts.take()
        for name in srvs:
            i_ms = 0.0
            if mode == "submit-insert-flush":
                _, q_ms = call(name, lambda s: s.submit(u, v))
                _, i_ms = call(name, lambda s: s.insert(ns, nd))
                ans, f_ms = call(name, lambda s: s.flush(
                    consistency="as-of-submit")[0])
                q_ms += f_ms
            else:
                ans, q_ms = call(name, lambda s: s.query(u, v))
                if mode == "query-then-insert":
                    _, i_ms = call(name, lambda s: s.insert(ns, nd))
            answers[name] = ans
            line[name] = {"query_ms": q_ms, "insert_ms": i_ms}
        line["collectives"] = counts.take()
        if not np.array_equal(answers["mesh"], answers["replicated"]):
            raise AssertionError(f"query mesh round {r}: answers differ "
                                 "from the replicated server's")
        c = line["collectives"]
        if (c["gathers"], c["all_reduce"], c["all_to_all_single"]) \
                != (1, 0, 0):
            raise AssertionError(f"query mesh round {r}: one all-gather "
                                 f"per label phase, not {c}")
        out["rounds"].append(line)

    served_round(0, "query-then-insert")
    served_round(1, "submit-insert-flush")
    ls, ld = live_edges(srvs["replicated"].index.graph)
    pairs, mult = np.unique(ls.astype(np.int64) * n + ld, return_counts=True)
    pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
    ds, dd = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
    out["delete_ms"] = {name: call(name, lambda s: s.delete(ds, dd))[1]
                        for name in srvs}
    served_round(2, "dirty")
    out["rebuild_ms"] = {name: call(name, lambda s: s.rebuild(
        mode="delta"))[1] for name in srvs}
    served_round(3, "clean")
    stats = [srv.engine.stats.as_dict() for srv in srvs.values()]
    if stats[0] != stats[1]:
        raise AssertionError(f"query mesh engine stats differ: {stats}")
    out["engine_stats"] = stats[0]
    out["launches"] = launches
    if any(c <= 0 for c in launches.values()):
        raise AssertionError(f"a kernel never launched on the query mesh: "
                             f"{launches}")
    return out


def _warm_up(mesh):
    """One vertex-sharded LJ build, untimed: the process's first build
    pays its allocator's and its collectives' warm-up, which no timed
    step of either halo mode should."""
    from repro_torch.core import make_graph
    from repro_torch.core import distributed as D
    from repro_torch.graphs.generators import table2_graph
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    g = make_graph(src, dst, n, m_cap=int(src.size), device=mesh.device)
    D.build_vertex_sharded(g, mesh, n_cap=n, k=64, k_prime=64,
                           max_iters=64, check="raise")


def _sharded_rank(rank, world, store_path, out_dir):
    """One gloo rank of the 4-rank world on the one card: probe whether
    gloo carries CUDA tensors, then every configuration's lifecycle, then
    the query mesh's serving stream."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        mesh = D.vertex_mesh()
        err = None
        try:
            x = torch.arange(2 * world, dtype=torch.int32,
                             device=mesh.device)
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            t = torch.ones(1, dtype=torch.int64, device=mesh.device)
            dist.all_reduce(t)
            want = torch.tensor([2 * rank, 2 * rank + 1] * world,
                                dtype=torch.int32)
            gathered = D.fan_out(mesh, lambda a, b: a + b, x[:world],
                                 x[:world])
            if not torch.equal(y.cpu(), want) or int(t) != world \
                    or not torch.equal(gathered, 2 * x[:world]):
                err = (f"gloo gave wrong results on CUDA tensors: {y}, {t}, "
                       f"{gathered}")
        except Exception as e:          # the refusal is the result
            err = f"{type(e).__name__}: {e}"
        ok = torch.tensor([0 if err else 1])
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        result = {"rank": rank, "device": str(mesh.device)}
        if int(ok) == 0:
            result["refused"] = err or "another rank's probe failed"
        else:
            _warm_up(mesh)
            for name, extra in SHARDED_CONFIGS:
                result[name] = sharded_lifecycle(mesh, extra)
            result["query_mesh"] = query_mesh_serve(D.query_mesh())
            result["gspmd"] = gspmd_lifecycle((2, 2))
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


#: the leaves of an index the auto-partitioned scheme lays out
_SCHEME_LEAVES = ("graph.src", "graph.dst", "graph.del_at", "graph.n",
                  "landmarks", "dl_in", "dl_out", "bl_in", "bl_out",
                  "packed.dl_in", "packed.dl_out", "packed.bl_in",
                  "packed.bl_out", "bl_sources", "bl_sinks")
_SCHEME_HOST = ("graph.m", "graph.del_epoch", "epoch", "label_del_epoch",
                "saturated")


def _field(obj, name):
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _scheme_hold(step, idx, rep):
    """This rank's block of every leaf of the scheme-sharded ``idx``
    against the same block of the replicated ``rep``, and the host
    fields, bit for bit; raises on the first difference."""
    import torch
    from repro_torch.core import distributed as D
    lays = D.index_shardings(idx.scheme)
    for name in _SCHEME_LEAVES:
        want = _field(lays, name).shard(_field(rep, name))
        if not torch.equal(_field(idx, name), want):
            raise AssertionError(f"gspmd {step}: {name} differs from the "
                                 "replicated port's")
    for name in _SCHEME_HOST:
        if _field(idx, name) != _field(rep, name):
            raise AssertionError(f"gspmd {step}: {name} "
                                 f"{_field(idx, name)} != replicated "
                                 f"{_field(rep, name)}")


def gspmd_lifecycle(shape, device=None):
    """The auto-partitioned scheme (``distributed_build``,
    ``distributed_insert``, ``shard_index``) through the LJ lifecycle at
    full width on a launch mesh of ``shape`` over the process group,
    beside the replicated port on the same card: build, GSPMD_INSERTS
    inserts of INSERTS edges, the verdicts of QUERIES lanes, a delete of
    DELETES single-slot pairs, a dirty query of GSPMD_QUERIES lanes, the
    rebuild, the re-placement onto the 1-axis mesh and ``QueryEngine(
    mesh=<that mesh>, bfs_kernel=True)`` over ``reach_place_index``.
    Every step's blocks and answers equal the replicated port's bit for
    bit; every fixpoint round issues one ``all_reduce``.  Returns the
    steps' ms beside the replicated ones, rounds, the collectives' calls
    and bytes, and the kernels' launches on the scheme's calls."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.core import distributed as D
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.sharding import reach_place_index
    from repro_torch.serve.engine import QueryEngine

    mesh = make_mesh_compat(shape, ("data", "model")[:len(shape)],
                            device=device)
    dev, d = mesh.device, mesh.size
    sync = _sync_time if dev.type == "cuda" else _host_time
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    m_cap = -(-(m + GSPMD_INSERTS * INSERTS) // d) * d
    g = make_graph(src, dst, n, m_cap=m_cap, device=dev)
    rng = np.random.default_rng(13)
    kw = dict(max_iters=64, check="raise")
    counters = {k: f for k, f in _counters().items()
                if k in ("verdicts_kernel", "admit_kernel")}
    launches = dict.fromkeys(counters, 0)
    out = {"mesh": list(shape), "m_cap": m_cap, "ms": {},
           "replicated_ms": {}, "rounds": {}, "traffic": {}}

    def counted(fn):
        for k in counters.values():
            k.launches = 0
        res = fn()
        for name, k in counters.items():
            launches[name] += k.launches
        return res

    def step(name, fn, rep_fn):
        """``fn(traffic, rounds)`` on the scheme (every rank waits for the
        others first) and ``rep_fn()``, timed; the blocks held."""
        tr, rounds = D.SchemeTraffic(), []
        dist.all_reduce(torch.zeros(1, device=dev))
        idx, out["ms"][name] = sync(lambda: fn(tr, rounds))
        rep, out["replicated_ms"][name] = sync(rep_fn)
        _scheme_hold(name, idx, rep)
        out["rounds"][name] = [int(r) for r in rounds]
        t = tr.as_dict()
        if t["all_reduce_calls"] != sum(min(r, 64) for r in rounds):
            raise AssertionError(f"gspmd {name}: {t} for rounds {rounds}: "
                                 "not one all_reduce a round")
        t["bytes_per_round"] = t["all_reduce_bytes"] / max(
            t["all_reduce_calls"], 1)
        out["traffic"][name] = t
        return idx, rep

    # untimed: a process's first build pays its allocator's and the
    # relax's first launches, which no timed step should
    D.distributed_build(g, mesh, n_cap=n, k=64, k_prime=64, **kw)
    idx, rep = step(
        "build", lambda tr, r: D.distributed_build(
            g, mesh, n_cap=n, k=64, k_prime=64, rounds=r, traffic=tr, **kw),
        lambda: DBLIndex.build(g, n_cap=n, k=64, k_prime=64, device=dev,
                               **kw))
    u = rng.integers(0, n, QUERIES).astype(np.int32)
    v = rng.integers(0, n, QUERIES).astype(np.int32)
    verd, out["verdicts_ms"] = counted(lambda: sync(
        lambda: D.distributed_label_verdicts(idx, mesh, u, v)))
    if not torch.equal(verd, rep.label_verdicts(u, v)):
        raise AssertionError("gspmd verdicts differ from the replicated "
                             "port's")
    for b in range(GSPMD_INSERTS):
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        prev = rep
        idx, rep = step(
            f"insert{b}", lambda tr, r: D.distributed_insert(
                idx, mesh, ns, nd, rounds=r, traffic=tr, **kw),
            lambda: prev.insert_edges(ns, nd, **kw))
        if idx.scheme != mesh or idx.epoch != b + 1:
            raise AssertionError(f"gspmd insert{b}: left the scheme")
    ls, ld = live_edges(rep.graph)
    pairs, mult = np.unique(ls.astype(np.int64) * n + ld, return_counts=True)
    pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
    ds, dd = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
    idx_d, out["delete_ms"] = sync(lambda: idx.delete_edges(ds, dd))
    rep_d = rep.delete_edges(ds, dd)
    _scheme_hold("delete", idx_d, rep_d)
    u2 = rng.integers(0, n, GSPMD_QUERIES).astype(np.int32)
    v2 = rng.integers(0, n, GSPMD_QUERIES).astype(np.int32)
    q = dict(bfs_chunk=BFS_CHUNK, max_iters=64)
    ans, out["dirty_query_ms"] = counted(lambda: sync(
        lambda: idx_d.query(u2, v2, **q)))
    if not np.array_equal(ans, rep_d.query(u2, v2, **q)):
        raise AssertionError("gspmd dirty query differs")
    step("rebuild", lambda tr, r: idx_d.rebuild(**kw),
         lambda: rep_d.rebuild(**kw))
    mesh2 = make_mesh_compat((d,), ("data",), device=device)
    idx3, out["replace_ms"] = sync(lambda: D.shard_index(idx, mesh2))
    _scheme_hold("replace", idx3, rep)
    if not torch.equal(D.distributed_label_verdicts(idx3, mesh2, u, v),
                       rep.label_verdicts(u, v)):
        raise AssertionError("gspmd verdicts after the re-placement differ")
    eng = QueryEngine(bfs_chunk=BFS_CHUNK, max_iters=64, bfs_kernel=True,
                      mesh=mesh2)
    placed, out["place_ms"] = sync(lambda: reach_place_index(idx3, mesh2))
    ans, out["engine_round_ms"] = counted(lambda: sync(
        lambda: eng.run(placed, u, v)))
    want = QueryEngine(rep, bfs_chunk=BFS_CHUNK, max_iters=64,
                       bfs_kernel=True).run(rep, u, v)
    if not np.array_equal(ans, want):
        raise AssertionError("gspmd engine over the launch mesh differs")
    out["launches"] = launches
    if dev.type == "cuda" and any(c <= 0 for c in launches.values()):
        raise AssertionError(f"a kernel never launched on the scheme's "
                             f"path: {launches}")
    out["plane_bytes_per_round"] = {"dl": n * 64, "bl": n * 64}
    return out


def _halo_bytes(rows, d, row_bytes):
    """Bytes one dense halo round moves between ranks, per direction: each
    ordered pair of ranks ships its whole ``rows``-slot buffer, a row of
    ``row_bytes`` and a one-byte frontier flag per slot."""
    return [d * (d - 1) * h * (row_bytes + 1) for h in rows]


def _sparse_line(res):
    """The sparse halo's numbers of a lifecycle: ms per step beside the
    dense ones, both telemetry dicts and both modes' counted collectives
    (calls and the bytes of the tensors each rank sent)."""
    h = res.pop("halo")
    return {"ms": res.pop("sparse_ms"), "dense_ms": res["ms"],
            "telemetry": {m: h[m]["telemetry"] for m in h},
            "wire": {m: h[m]["wire"] for m in h}}


def sharded_phase(card):
    """The vertex-sharded lifecycle (dense and sparse halo) on the card,
    then the query mesh's serving stream: a world of one over NCCL in this
    process, then 4 gloo ranks sharing the card.  Returns the kernels'
    launches on the query mesh (the vertex-sharded path has none)."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from repro_torch.core import distributed as D

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="sharded_", dir=build_dir))
    try:
        dist.init_process_group("nccl", init_method=f"file://{work}/nccl",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=SHARDED_TIMEOUT_S))
        try:
            mesh = D.vertex_mesh()
            # NCCL sets up its communicator at the first collective
            one = torch.ones(1, device=mesh.device)
            _, first_ms = _sync_time(lambda: dist.all_reduce(one))
            _warm_up(mesh)
            world1 = {name: sharded_lifecycle(
                mesh, extra, card if name == "bool" else None)
                for name, extra in SHARDED_CONFIGS}
            qm1 = query_mesh_serve(D.query_mesh())
            gs1 = gspmd_lifecycle((1, 1))
        finally:
            dist.destroy_process_group()
        launches = dict(qm1["launches"])
        for k, c in gs1["launches"].items():
            launches[k] += c
        emit("gspmd_world1", backend="nccl", bitwise=True, card=card, **gs1)
        emit("query_mesh_world1", backend="nccl", device=str(mesh.device),
             answers_equal=True, card=card, **qm1)
        for name, res in world1.items():
            serve = res.pop("serve")
            emit("sharded_sparse_world1", config=name, backend="nccl",
                 bitwise=True, rounds_equal=True, card=card,
                 **SPARSE_HALO, **_sparse_line(res))
            emit("sharded_world1", config=name, backend="nccl",
                 device=str(mesh.device), bitwise=True,
                 first_collective_ms=first_ms, card=card, **res)
            emit("sharded_serve_world1", config=name, backend="nccl",
                 device=str(mesh.device), bitwise=True, card=card, **serve)

        t = time.perf_counter()
        ctx = tmp.spawn(_sharded_rank, nprocs=SHARDED_RANKS, join=False,
                        args=(SHARDED_RANKS, str(work / "gloo"), str(work)))
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t > SHARDED_TIMEOUT_S:
                    raise AssertionError(
                        f"the {SHARDED_RANKS}-rank world ran past "
                        f"{SHARDED_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(SHARDED_RANKS)]
        refused = [r["refused"] for r in ranks if "refused" in r]
        if not refused:
            qm = [r.pop("query_mesh") for r in ranks]
            for k in launches:
                launches[k] += sum(q["launches"][k] for q in qm)
            gs = [r.pop("gspmd") for r in ranks]
            for k in launches:
                launches[k] += sum(x["launches"][k] for x in gs)
            emit("gspmd_4rank", backend="gloo", ranks=SHARDED_RANKS,
                 bitwise=True, mesh=gs[0]["mesh"], m_cap=gs[0]["m_cap"],
                 ms=[x["ms"] for x in gs],
                 replicated_ms=[x["replicated_ms"] for x in gs],
                 rounds=gs[0]["rounds"], traffic=gs[0]["traffic"],
                 verdicts_ms=[x["verdicts_ms"] for x in gs],
                 delete_ms=[x["delete_ms"] for x in gs],
                 dirty_query_ms=[x["dirty_query_ms"] for x in gs],
                 replace_ms=[x["replace_ms"] for x in gs],
                 place_ms=[x["place_ms"] for x in gs],
                 engine_round_ms=[x["engine_round_ms"] for x in gs],
                 plane_bytes_per_round=gs[0]["plane_bytes_per_round"],
                 launches=[x["launches"] for x in gs], card=card)
            emit("query_mesh_4rank", backend="gloo", ranks=SHARDED_RANKS,
                 answers_equal=True,
                 lanes_per_rank=qm[0]["lanes_per_rank"],
                 rounds=[q["rounds"] for q in qm],
                 delete_ms=[q["delete_ms"] for q in qm],
                 rebuild_ms=[q["rebuild_ms"] for q in qm],
                 engine_stats=qm[0]["engine_stats"],
                 launches=[q["launches"] for q in qm], card=card)
        bytes_line = {name: {"world1_per_device": world1[name]
                             ["label_bytes"][0],
                             "replicated": world1[name]["label_bytes"][1]}
                      for name, _ in SHARDED_CONFIGS}
        if refused:
            emit("sharded_4rank_refused", backend="gloo", ranks=SHARDED_RANKS,
                 error=refused[0], card=card)
        else:
            for name, extra in SHARDED_CONFIGS:
                res = [r[name] for r in ranks]
                serve = [r.pop("serve") for r in res]
                sparse = [_sparse_line(r) for r in res]
                tel = sparse[0]["telemetry"]
                if any(sp["telemetry"] != tel for sp in sparse):
                    raise AssertionError(f"{name}: the ranks' halo "
                                         "telemetry differs")
                if tel["sparse"]["halo_bytes"] >= tel["dense"]["halo_bytes"]:
                    raise AssertionError(
                        f"{name}: the sparse halo modeled no fewer bytes "
                        f"than the dense one at {SHARDED_RANKS} ranks: {tel}")
                wire = {mode: {k: sum(sp["wire"][mode][k] for sp in sparse)
                               for k in sparse[0]["wire"][mode]}
                        for mode in ("dense", "sparse")}
                emit("sharded_sparse_4rank", config=name, backend="gloo",
                     ranks=SHARDED_RANKS, bitwise=True, rounds_equal=True,
                     **SPARSE_HALO, ms=[sp["ms"] for sp in sparse],
                     dense_ms=[sp["dense_ms"] for sp in sparse],
                     telemetry=tel, wire_all_ranks=wire, card=card)
                emit("sharded_serve_4rank", config=name, backend="gloo",
                     ranks=SHARDED_RANKS, bitwise=True,
                     rounds=[s["rounds"] for s in serve],
                     delete_ms=[s["delete_ms"] for s in serve],
                     rebuild_ms=[s["rebuild_ms"] for s in serve],
                     rebuild_info=serve[0]["rebuild_info"],
                     rebuild_collectives=serve[0]["rebuild_collectives"],
                     engine_stats=serve[0]["engine_stats"],
                     row_all_reduce_bytes=serve[0]["row_all_reduce_bytes"],
                     il_all_reduce_bytes=serve[0]["il_all_reduce_bytes"],
                     card=card)
                emit("sharded_4rank", config=name, backend="gloo",
                     ranks=SHARDED_RANKS, devices=[r["device"]
                                                   for r in ranks],
                     bitwise=True, wall_s=time.perf_counter() - t,
                     ms=[r["ms"] for r in res],
                     replicated_ms=[r["replicated_ms"] for r in res],
                     plan_ms=[r["plan_ms"] for r in res],
                     extend_ms=[r["extend_ms"] for r in res],
                     rounds=res[0]["rounds"], halo_rows=res[0]["halo_rows"],
                     bucket_edges=[r["fwd_bucket_edges"] for r in res],
                     card=card)
                bytes_line[name].update(
                    ranks4_per_device=[r["label_bytes"][0] for r in res],
                    halo_rows_4rank=res[0]["halo_rows"],
                    # OR rows: 128 uint8 lanes, or four int32 words
                    halo_bytes_per_round_4rank=_halo_bytes(
                        res[0]["halo_rows"], SHARDED_RANKS,
                        16 if extra.get("plane_repr") == "packed" else 128),
                    halo_bytes_per_round_world1=0)
                if "families" in extra:
                    # MIN rows: 2 * il_dim int32 ranks
                    bytes_line[name]["il_halo_bytes_per_round_4rank"] = \
                        _halo_bytes(res[0]["halo_rows"], SHARDED_RANKS,
                                    8 * extra["il_dim"])
                if any(r["label_bytes"][0] * SHARDED_RANKS
                       != r["label_bytes"][1] for r in res):
                    raise AssertionError("per-device label bytes x 4 != "
                                         "the replicated bytes")
        emit("sharded_bytes", card=card, **bytes_line)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


class _HostReach:
    """``query(u, v)`` answered by a host BFS over a fixed edge list (each
    distinct v's ancestors): the reachability-filtered sampler's index
    with no labels in it."""

    def __init__(self, n, src, dst):
        self.n, self.src, self.dst = n, src, dst

    def query(self, u, v):
        out = np.zeros(np.asarray(u).size, bool)
        for t, anc in host_reach(self.n, self.dst, self.src,
                                 np.unique(v)).items():
            sel = v == t
            out[sel] = anc[u[sel]]
        return out


def _same_sample(a, b):
    """Two sampled subgraphs are equal: nodes, and each block's edges."""
    return np.array_equal(a.nodes, b.nodes) and all(
        np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(a.blocks, b.blocks)
        for f in ("src", "dst", "edge_valid"))


def _start_examples(dev, examples):
    """Start each example twin as a subprocess on ``dev``: (procs, t0)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return {name: subprocess.Popen(
        [sys.executable, *args, "--device", dev.type], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in examples.items()}, time.perf_counter()


def _finish_examples(procs, t, endings=None):
    """Wait for the twins ``_start_examples`` started; each must exit 0
    with ``OK`` (or its entry of ``endings``) ending its last line.
    {name: result}."""
    out = {}
    try:
        for name, proc in procs.items():
            left = EXAMPLE_TIMEOUT_S - (time.perf_counter() - t)
            stdout, stderr = proc.communicate(timeout=max(left, 1))
            lines = stdout.strip().splitlines()
            if proc.returncode != 0 or not lines or \
                    not lines[-1].endswith((endings or {}).get(name, "OK")):
                raise AssertionError(
                    f"{name} failed (rc {proc.returncode}): "
                    f"{stdout[-1000:]} {stderr[-2000:]}")
            out[name] = dict(rc=0, wall_s=time.perf_counter() - t,
                             last_lines=lines[-2:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    return out


#: the AOT phase's two engines: the grid kernels, and the streamed ones
AOT_RUNS = (("grid", dict(bfs_kernel=True)),
            ("streamed", dict(bfs_kernel=True, streaming=True)))
AOT_CHILD_TIMEOUT_S = 300
#: the four kernels by the kernels line's names
KERNELS = ("verdicts_kernel", "admit_kernel", "streamed_verdicts_kernel",
           "streamed_admit_kernel")


def _counters():
    """The wrappers that count each kernel's launches, by name."""
    from repro_torch.kernels.bfs_prune import bfs_prune as B
    from repro_torch.kernels.dbl_query import dbl_query as V
    return dict(zip(KERNELS, (V.dbl_query_verdicts, B.bfs_admit_plane,
                              V.dbl_query_verdicts_streamed,
                              B.bfs_admit_plane_streamed)))


def _launch_counts():
    return {name: f.launches for name, f in _counters().items()}


def _kernel_of(name):
    """The kernels line's name of a profiled CUDA kernel, or None."""
    for k in ("streamed_verdicts_kernel", "streamed_admit_kernel",
              "verdicts_kernel", "admit_kernel"):
        if k in name:
            return k
    return None


def _aot_engine(idx, knobs):
    from repro_torch.serve.engine import QueryEngine
    return QueryEngine(idx, bfs_chunk=BFS_CHUNK, max_iters=64, **knobs)


def _timed_round(eng, u, v):
    import torch
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else \
        (lambda: None)
    sync()
    t = time.perf_counter()
    ans = eng.query(u, v)
    sync()
    return ans, (time.perf_counter() - t) * 1e3


def aot_child(argv):
    """A fresh serving process over the AOT cache (``aot_phase``), run as
    ``python -c 'import sys, chip_smoke; chip_smoke.aot_child(
    sys.argv[1:])' <work dir> <t0> <cold> <device> <run> ...``.  For each
    run of ``AOT_RUNS`` named, in turn: load the saved index,
    ``aot_warmup`` (the round's batch) from ``<work>/cache_<run>`` (a cold
    child: from the empty ``<work>/cold_<run>``) and answer the first
    round of queries; the first run also reports the seconds since ``t0``
    (the parent's clock at the start).  A cold child stops there.  A warm
    one then times a round through the loaded programs against a live
    engine on a second copy of the index (loaded, live, live, loaded),
    profiles a loaded round (every dispatch must reach a loaded program),
    inserts, deletes and answers the second round on the dirty labels
    (again through loaded programs only: the dirty flag is an input of
    the programs), then times that dirty round against the live engine
    after the same insert and delete, in turns (loaded, live, live,
    loaded); the answers go to ``<run>_answers.npz``, one report a run to
    a line of stdout."""
    import torch
    from repro_torch.serve.aot import ShapeDispatcher
    work, t0, cold, dev = (Path(argv[0]), float(argv[1]), argv[2] == "1",
                           argv[3])
    data = np.load(work / "stream.npz")
    for i, run in enumerate(argv[4:]):
        out = _aot_child_run(work, run, cold, dev, data, t0 if i == 0
                             else None, torch, ShapeDispatcher)
        print(json.dumps(out), flush=True)


def _aot_child_run(work, run, cold, dev, data, t0, torch, ShapeDispatcher):
    knobs = dict(AOT_RUNS)[run]
    cache = work / (f"cold_{run}" if cold else f"cache_{run}")
    idx = torch.load(work / "index.pt", weights_only=False,
                     map_location=dev)
    eng = _aot_engine(idx, knobs)
    t = time.perf_counter()
    eng.aot_warmup(idx, cache, batch_sizes=(data["u1"].size,))
    warmup_ms = (time.perf_counter() - t) * 1e3
    launches = dict.fromkeys(KERNELS, 0)

    def loaded(fn):
        """``fn()`` on the loaded programs, its launches counted."""
        before = _launch_counts()
        res = fn()
        for k, c in _launch_counts().items():
            launches[k] += c - before[k]
        return res

    ans1, first_ms = loaded(lambda: _timed_round(eng, data["u1"],
                                                 data["v1"]))
    out = dict(run=run, cold=cold, warmup_ms=warmup_ms,
               first_round_ms=first_ms, hits=eng.aot_cache.hits,
               misses=eng.aot_cache.misses, stores=eng.aot_cache.stores,
               load_ms=[r["load_ms"] for r in eng.aot_cache.log
                        if r["event"] == "load"])
    if t0 is not None:
        out["first_batch_s"] = time.time() - t0
    if cold:
        return out
    live = _aot_engine(torch.load(work / "index.pt", weights_only=False,
                                  map_location=dev), knobs)
    _timed_round(live, data["u1"], data["v1"])    # the live path's warm-up
    rounds = {"loaded": [], "live": []}
    for name, e in (("loaded", eng), ("live", live), ("live", live),
                    ("loaded", eng)):
        run_e = functools.partial(_timed_round, e, data["u1"], data["v1"])
        ans, ms = loaded(run_e) if name == "loaded" else run_e()
        if not np.array_equal(ans, ans1):
            raise AssertionError(f"aot {run}: a {name} round differs from "
                                 "the first loaded round")
        rounds[name].append(ms)
    dispatchers = [eng._label_phase] + [d for pair in eng._coal_phases
                                        .values() for d in pair]
    assert all(isinstance(d, ShapeDispatcher) for d in dispatchers)
    # the CPU (a rehearsal) has no kernels to profile
    profile = _device_profile if dev == "cuda" else \
        (lambda fn: (fn(), 0, {}))
    _, _, per_kernel = loaded(lambda: profile(
        lambda: eng.query(data["u1"], data["v1"])))
    if sum(d.live_calls for d in dispatchers):
        raise AssertionError(f"aot {run}: a clean round ran a live phase")
    profiled = {}
    for k, (_, calls) in per_kernel.items():
        name = _kernel_of(k)
        if name:
            profiled[name] = profiled.get(name, 0) + calls
    for e in (eng, live):
        e.insert(data["ins_s"], data["ins_d"])
        e.delete(data["del_s"], data["del_d"])
    before = _launch_counts()
    ans2, dirty_ms = loaded(lambda: _timed_round(eng, data["u2"],
                                                 data["v2"]))
    dirty_launches = {k: c - before[k] for k, c in _launch_counts().items()}
    if sum(d.live_calls for d in dispatchers):
        raise AssertionError(f"aot {run}: a dirty round ran a live phase")
    _timed_round(live, data["u2"], data["v2"])    # the live dirty warm-up
    dirty = {"loaded": [], "live": []}
    for name, e in (("loaded", eng), ("live", live), ("live", live),
                    ("loaded", eng)):
        run_e = functools.partial(_timed_round, e, data["u2"], data["v2"])
        ans, ms = loaded(run_e) if name == "loaded" else run_e()
        if not np.array_equal(ans, ans2):
            raise AssertionError(f"aot {run}: a {name} dirty round differs "
                                 "from the first loaded dirty round")
        dirty[name].append(ms)
    if sum(d.live_calls for d in dispatchers):
        raise AssertionError(f"aot {run}: a dirty round ran a live phase")
    np.savez(work / f"{run}_answers.npz", ans1=ans1, ans2=ans2)
    out.update(loaded_round_ms=rounds["loaded"], live_round_ms=rounds["live"],
               dirty_round_ms=dirty_ms,
               loaded_dirty_round_ms=dirty["loaded"],
               live_dirty_round_ms=dirty["live"],
               dirty_launches=dirty_launches,
               live_calls=sum(d.live_calls for d in dispatchers),
               profiled_kernels=profiled, loaded_launches=launches,
               loaded_calls=sum(d.loaded_calls for d in dispatchers))
    return out


def _aot_children(work, cold, dev, runs):
    """Run ``aot_child`` on ``runs``: its reports, by run."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.aot_child(sys.argv[1:])", str(work), repr(time.time()),
         str(int(cold)), dev.type, *runs],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=AOT_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the aot child ({'cold' if cold else 'warm'}) "
                             f"failed (rc {proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    reports = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")]
    return {r["run"]: r for r in reports}


WARMUP_CHILD_TIMEOUT_S = 300


def warmup_child(argv):
    """A fresh serving process, run as ``python -c 'import sys,
    chip_smoke; chip_smoke.warmup_child(sys.argv[1:])' <work dir> <warm>
    <device>``: load the saved index, put ``QueryEngine(bfs_chunk=64,
    max_iters=64, bfs_kernel=True)`` over it, ``warmup`` it (the round's
    batch and every chunk bucket) when ``warm`` is 1, then serve a round,
    a second round, a delete of the saved pairs, two rounds on the dirty
    labels, the delta rebuild and a round on the rebuilt index.
    ``dispatch_shapes()`` is read after the warmup and after each of
    those; the answers go to ``<work>/answers<warm>.npz`` and the report
    to stdout."""
    import torch
    from repro_torch.serve.engine import QueryEngine
    work, warm, dev = Path(argv[0]), argv[1] == "1", argv[2]
    data = np.load(work / "stream.npz")
    idx = torch.load(work / "index.pt", weights_only=False,
                     map_location=dev)
    eng = QueryEngine(idx, bfs_chunk=BFS_CHUNK, max_iters=64,
                      bfs_kernel=True)
    out = {"warm": warm, "shapes": {}}
    before = _launch_counts()
    if warm:
        t = time.perf_counter()
        eng.warmup(idx, batch_sizes=(data["u1"].size,),
                   bfs_buckets=eng._chunk_buckets())
        if dev == "cuda":
            torch.cuda.synchronize()
        out["warmup_ms"] = (time.perf_counter() - t) * 1e3
        out["shapes"]["warmup"] = eng.dispatch_shape_counts()
    ans1, out["first_round_ms"] = _timed_round(eng, data["u1"], data["v1"])
    out["shapes"]["first_round"] = eng.dispatch_shape_counts()
    _, out["second_round_ms"] = _timed_round(eng, data["u1"], data["v1"])
    eng.delete(data["del_s"], data["del_d"])
    ans2, out["first_dirty_round_ms"] = _timed_round(eng, data["u2"],
                                                     data["v2"])
    out["shapes"]["dirty_round"] = eng.dispatch_shape_counts()
    again, out["second_dirty_round_ms"] = _timed_round(eng, data["u2"],
                                                       data["v2"])
    if not np.array_equal(again, ans2):
        raise AssertionError("two dirty rounds of the same queries differ")
    eng.rebuild(mode="delta")
    out["rebuild"] = eng.last_rebuild_info["mode"]
    ans3, out["rebuilt_round_ms"] = _timed_round(eng, data["u3"],
                                                 data["v3"])
    out["shapes"]["delta_rebuild"] = eng.dispatch_shape_counts()
    out["launches"] = {k: c - before[k] for k, c in _launch_counts().items()}
    np.savez(work / f"answers{int(warm)}.npz", ans1=ans1, ans2=ans2,
             ans3=ans3)
    print(json.dumps(out), flush=True)


def warmup_phase(dev, card):
    """``QueryEngine.warmup`` and ``dispatch_shapes`` at full LJ width: a
    fresh child serves the same stream with a warmup (``warm``) and one
    without (``cold``), both started after the kernels are built, so a
    cold first round pays the libraries' loads and every first dispatch
    itself; the stream has two rounds on dirty labels, after a delete and
    before the delta rebuild, which the (clean) warmup covers too.  The
    warm child's dispatch shapes after its warmup, its first round, its
    first dirty round and the delta rebuild must be equal; both
    children's answers must equal this process's engine's.  Returns the
    children's launches."""
    import os
    import torch
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.serve.engine import QueryEngine

    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    rng = np.random.default_rng(31)
    g = make_graph(src, dst, n, m_cap=int(src.size), device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, max_iters=64,
                         check="raise", device=dev)
    pairs, mult = np.unique(src.astype(np.int64) * n + dst,
                            return_counts=True)
    pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
    data = dict(u1=rng.integers(0, n, QUERIES).astype(np.int32),
                v1=rng.integers(0, n, QUERIES).astype(np.int32),
                u3=rng.integers(0, n, QUERIES).astype(np.int32),
                v3=rng.integers(0, n, QUERIES).astype(np.int32),
                del_s=(pick // n).astype(np.int32),
                del_d=(pick % n).astype(np.int32))
    data.update(u2=rng.integers(0, n, QUERIES).astype(np.int32),
                v2=rng.integers(0, n, QUERIES).astype(np.int32))
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="warmup_", dir=build_dir))
    try:
        np.savez(work / "stream.npz", **data)
        torch.save(idx, work / "index.pt")
        eng = QueryEngine(idx, bfs_chunk=BFS_CHUNK, max_iters=64,
                          bfs_kernel=True)
        want1 = eng.query(data["u1"], data["v1"])
        eng.delete(data["del_s"], data["del_d"])
        want2 = eng.query(data["u2"], data["v2"])
        eng.rebuild(mode="delta")
        want3 = eng.query(data["u3"], data["v3"])
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        reports = {}
        for warm in (False, True):
            proc = subprocess.run(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.warmup_child(sys.argv[1:])", str(work),
                 str(int(warm)), dev.type], cwd=ROOT, env=env,
                capture_output=True, text=True,
                timeout=WARMUP_CHILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"the warmup child (warm={warm}) "
                                     f"failed (rc {proc.returncode}): "
                                     f"{proc.stderr[-3000:]}")
            rep = json.loads(proc.stdout.strip().splitlines()[-1])
            got = np.load(work / f"answers{int(warm)}.npz")
            if not (np.array_equal(got["ans1"], want1)
                    and np.array_equal(got["ans2"], want2)
                    and np.array_equal(got["ans3"], want3)):
                raise AssertionError(f"the warmup child (warm={warm}) "
                                     "answered otherwise than this "
                                     "process's engine")
            reports["warm" if warm else "cold"] = rep
        shapes = list(reports["warm"]["shapes"].values())
        if any(s != shapes[0] for s in shapes):
            raise AssertionError(f"a warmed engine made new dispatch "
                                 f"shapes: {reports['warm']['shapes']}")
        emit("warmup", card=card, queries=QUERIES,
             dispatch_shapes=reports["warm"]["shapes"],
             cold_dispatch_shapes=reports["cold"]["shapes"],
             warmup_ms=reports["warm"]["warmup_ms"],
             first_round_ms={k: r["first_round_ms"]
                             for k, r in reports.items()},
             second_round_ms={k: r["second_round_ms"]
                              for k, r in reports.items()},
             first_dirty_round_ms={k: r["first_dirty_round_ms"]
                                   for k, r in reports.items()},
             second_dirty_round_ms={k: r["second_dirty_round_ms"]
                                    for k, r in reports.items()},
             rebuilt_round_ms={k: r["rebuilt_round_ms"]
                               for k, r in reports.items()},
             rebuild=reports["warm"]["rebuild"],
             launches={k: r["launches"] for k, r in reports.items()})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {k: sum(r["launches"][k] for r in reports.values())
            for k in KERNELS}


def aot_phase(dev, card):
    """The AOT cache (``serve/aot.py``) at full LJ width: for each engine
    of ``AOT_RUNS``, this process warms up into an empty cache (every
    program exported and saved); one fresh child warms every engine up
    from its cache (every file must hit, none miss) and serves
    (``aot_child``), and a second child starts the first engine from an
    empty cache.  The child's answers must equal a live engine's in this
    process bitwise, and the first round's residue lanes and 64 random
    lanes of each round a host BFS over that round's edges.  In the warm
    child each profiled loaded round, and the first dirty round, must
    launch both kernels of its engine, and no dispatch, clean or dirty,
    may run a live phase.  Returns the kernels' launches from loaded
    programs."""
    import torch
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.kernels.dbl_query.dbl_query import verdicts_plain

    t_phase = time.perf_counter()
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(24)
    g = make_graph(src, dst, n, m_cap=m + INSERTS, device=dev)
    idx = DBLIndex.build(g, n_cap=n, k=64, k_prime=64, max_iters=64,
                         check="raise", device=dev)
    pairs, mult = np.unique(src.astype(np.int64) * n + dst,
                            return_counts=True)
    pick = rng.choice(pairs[mult == 1], DELETES, replace=False)
    data = dict(u1=rng.integers(0, n, QUERIES).astype(np.int32),
                v1=rng.integers(0, n, QUERIES).astype(np.int32),
                u2=rng.integers(0, n, QUERIES).astype(np.int32),
                v2=rng.integers(0, n, QUERIES).astype(np.int32),
                ins_s=rng.integers(0, n, INSERTS).astype(np.int32),
                ins_d=rng.integers(0, n, INSERTS).astype(np.int32),
                del_s=(pick // n).astype(np.int32),
                del_d=(pick % n).astype(np.int32))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_aot_"))
    try:
        np.savez(work / "stream.npz", **data)
        torch.save(idx, work / "index.pt")
        # the oracle's inputs: round 1's residue lanes (by the labels) and
        # edges, round 2's edges after the insert and the delete
        verd = verdicts_plain(*idx.packed, torch.from_numpy(data["u1"]).to(
            dev), torch.from_numpy(data["v1"]).to(dev)).cpu().numpy()
        residue = np.flatnonzero(verd == -1)
        dead = np.isin(src.astype(np.int64) * n + dst, pick)
        edges2 = (np.concatenate([src[~dead], data["ins_s"]]),
                  np.concatenate([dst[~dead], data["ins_d"]]))
        stores, wants = {}, {}
        for run, knobs in AOT_RUNS:
            cache = work / f"cache_{run}"
            eng = _aot_engine(idx, knobs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.aot_warmup(idx, cache, batch_sizes=(QUERIES,))
            warm_s = time.perf_counter() - t
            stores[run] = eng.aot_cache.stores
            entries = [r for r in eng.aot_cache.log if r["event"] == "store"]
            if eng.aot_cache.hits or not entries or \
                    len(list(cache.glob("*.pt2"))) != stores[run]:
                raise AssertionError(f"aot {run}: the first warm-up hit "
                                     f"{eng.aot_cache.hits}, stored "
                                     f"{stores[run]}")
            emit("aot_store", run=run, card=card, warmup_s=warm_s,
                 entries=[{k: r[k] for k in ("tag", "export_ms", "save_ms",
                                             "bytes")} for r in entries])
            # the live answers, on a fresh copy of the index
            live = _aot_engine(torch.load(work / "index.pt",
                                          weights_only=False,
                                          map_location=dev), knobs)
            want1 = live.query(data["u1"], data["v1"])
            live.insert(data["ins_s"], data["ins_d"])
            live.delete(data["del_s"], data["del_d"])
            wants[run] = (want1, live.query(data["u2"], data["v2"]))
        runs = [run for run, _ in AOT_RUNS]
        warm = _aot_children(work, False, dev, runs)
        cold = _aot_children(work, True, dev, runs[:1])[runs[0]]
        if cold["stores"] != stores[runs[0]]:
            raise AssertionError(f"aot: the cold child stored "
                                 f"{cold['stores']} of {stores[runs[0]]}")
        launches = dict.fromkeys(KERNELS, 0)
        wanted = {"grid": ("verdicts_kernel", "admit_kernel"),
                  "streamed": ("streamed_verdicts_kernel",
                               "streamed_admit_kernel")}
        for run in runs:
            w = warm[run]
            if w["hits"] != stores[run] or w["misses"] or w["stores"]:
                raise AssertionError(f"aot {run}: the fresh process hit "
                                     f"{w['hits']} of {stores[run]}, "
                                     f"missed {w['misses']}")
            got = np.load(work / f"{run}_answers.npz")
            for name, a, b in (("round 1", got["ans1"], wants[run][0]),
                               ("round 2", got["ans2"], wants[run][1])):
                if not np.array_equal(a, b):
                    raise AssertionError(
                        f"aot {run}: {name} through loaded programs differs "
                        f"from the live engine in {int((a != b).sum())} "
                        "lanes")
            checked = 0
            for ans, u, v, (es, ed), lanes in (
                    (got["ans1"], data["u1"], data["v1"], (src, dst),
                     residue),
                    (got["ans2"], data["u2"], data["v2"], edges2,
                     np.zeros(0, np.int64))):
                lanes = np.union1d(lanes, rng.choice(
                    QUERIES, RANDOM_CHECKS, replace=False))
                reach = host_reach(n, es, ed, np.unique(u[lanes]))
                want = np.array([reach[int(u[i])][v[i]] for i in lanes])
                if (ans[lanes] != want).any():
                    raise AssertionError(f"aot {run}: answers differ from "
                                         "the host BFS")
                checked += lanes.size
            for k in wanted[run]:
                if w["profiled_kernels"].get(k, 0) <= 0 or \
                        w["loaded_launches"][k] <= 0:
                    raise AssertionError(f"aot {run}: {k} not launched "
                                         "from a loaded program")
                if w["dirty_launches"][k] <= 0:
                    raise AssertionError(f"aot {run}: {k} not launched "
                                         "by the dirty round's loaded "
                                         "programs")
            if w["live_calls"]:
                raise AssertionError(f"aot {run}: {w['live_calls']} "
                                     "dispatches ran a live phase")
            for k, c in w["loaded_launches"].items():
                launches[k] += c
            emit("aot_child", run=run, card=card, residue_lanes=residue.size,
                 checked_lanes=checked, bitwise_with_live=True,
                 warm={k: v for k, v in w.items() if k not in ("run",
                                                               "cold")},
                 cold={k: v for k, v in cold.items() if k not in ("run",
                                                                  "cold")}
                 if run == runs[0] else None)
        emit("aot", card=card, launches_from_loaded_programs=launches,
             wall_s=time.perf_counter() - t_phase)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def baselines_phase(dev, card):
    """The paper's baselines beside DBL on the LJ preset at full size:
    a DBL server, B-BFS and IP-lite answer the same queries (equal to each
    other and to a host BFS), both indexes take the same inserts; the
    DAG-maintenance proxy (host Kosaraju and one FW-BW round on the card,
    which must agree); the reachability-filtered sampler through the DBL
    index and through a host BFS (equal subgraphs); and both example twins.
    Returns the grid kernels' launches in this phase."""
    import torch
    from repro_torch.baselines import bbfs
    from repro_torch.baselines.dag_maintain import (dag_stats,
                                                    scc_condense_numpy,
                                                    scc_fwbw_round)
    from repro_torch.baselines.ip_lite import IPIndex, ip_verdicts
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.graphs.sampler import CSR, reachability_filtered_sample
    from repro_torch.kernels.bfs_prune.bfs_prune import bfs_admit_plane
    from repro_torch.kernels.dbl_query.dbl_query import dbl_query_verdicts
    from repro_torch.serve.engine import QueryEngine
    from repro_torch.serve.reach_server import ReachabilityServer

    t_phase = time.perf_counter()
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    rng = np.random.default_rng(3)
    dbl_query_verdicts.launches = 0
    bfs_admit_plane.launches = 0
    g = make_graph(src, dst, n, m_cap=m + BASE_ROUNDS * INSERTS, device=dev)
    idx, dbl_build_ms = _sync_time(lambda: DBLIndex.build(
        g, n_cap=n, k=64, k_prime=64, max_iters=64, check="raise",
        device=dev))
    ip, ip_build_ms = _sync_time(lambda: IPIndex.build(
        g, n_cap=n, k=IP_K, max_iters=64))
    srv = ReachabilityServer(index=None, engine=QueryEngine(
        idx, bfs_chunk=BFS_CHUNK, max_iters=64, bfs_kernel=True))
    rounds = []
    checked = 0
    for r in range(BASE_ROUNDS):
        u = rng.integers(0, n, BASE_QUERIES).astype(np.int32)
        v = rng.integers(0, n, BASE_QUERIES).astype(np.int32)
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        snap = srv.index
        es, ed = live_edges(snap.graph)
        residue = _residue_lanes(snap, u, v)
        dbl, dbl_ms = _sync_time(lambda: srv.query(u, v))
        bb, bbfs_ms = _sync_time(lambda: bbfs.query(
            srv.index.graph, u, v, n_cap=n, chunk=BFS_CHUNK, max_iters=64))
        ipa, ip_ms = _sync_time(lambda: ip.query(u, v, chunk=BFS_CHUNK))
        for name, ans in (("B-BFS", bb), ("IP-lite", ipa)):
            if not np.array_equal(ans, dbl):
                raise AssertionError(
                    f"baselines round {r}: {name} differs from the DBL "
                    f"server on {int((ans != dbl).sum())} lanes")
        lanes = np.union1d(residue, rng.choice(BASE_QUERIES, RANDOM_CHECKS,
                                               replace=False))
        reach = host_reach(n, es, ed, np.unique(u[lanes]))
        want = np.array([reach[int(u[i])][v[i]] for i in lanes])
        bad = int((dbl[lanes] != want).sum())
        if bad:
            raise AssertionError(f"baselines round {r}: {bad} of "
                                 f"{lanes.size} checked answers differ from "
                                 "the host BFS")
        checked += lanes.size
        ip_unknown = int((ip_verdicts(ip, torch.from_numpy(u).to(dev),
                                      torch.from_numpy(v).to(dev)) == -1)
                         .sum())
        _, dbl_insert_ms = _sync_time(lambda: srv.insert(ns, nd))
        ip, ip_insert_ms = _sync_time(lambda: ip.insert_edges(
            ns, nd, max_iters=64))
        rounds.append(dict(
            round=r, query_ms={"dbl_server": dbl_ms, "bbfs": bbfs_ms,
                               "ip_lite": ip_ms},
            insert_ms={"dbl": dbl_insert_ms, "ip_lite": ip_insert_ms},
            reachable=int(dbl.sum()), dbl_residue_lanes=int(residue.size),
            ip_unknown_lanes=ip_unknown))

    t = time.perf_counter()
    dag = dag_stats(n, src, dst)
    dag_stats_s = time.perf_counter() - t
    t = time.perf_counter()
    comp, _, _ = scc_condense_numpy(n, src, dst)
    condense_s = time.perf_counter() - t
    every = torch.ones(n, dtype=torch.bool, device=dev)
    (scc, _, _), fwbw_ms = _sync_time(lambda: scc_fwbw_round(
        g, every, n_cap=n, max_iters=n))
    scc = scc.cpu().numpy()
    if not np.array_equal(scc, comp == comp[0]):
        raise AssertionError("scc_fwbw_round's pivot SCC differs from "
                             "Kosaraju's")

    ls, ld = live_edges(srv.index.graph)
    csr = CSR.from_edges(n, ls, ld)
    targets = np.argsort(-np.bincount(ld, minlength=n))[:SAMPLE_TARGETS] \
        .astype(np.int32)
    seeds = np.random.default_rng(4).choice(n, SAMPLE_SEEDS, replace=False)
    sub, sample_ms = _sync_time(lambda: reachability_filtered_sample(
        csr, seeds, FANOUTS, srv.index, targets,
        rng=np.random.default_rng(5)))
    t = time.perf_counter()
    host_sub = reachability_filtered_sample(
        csr, seeds, FANOUTS, _HostReach(n, ls, ld), targets,
        rng=np.random.default_rng(5))
    host_sample_ms = (time.perf_counter() - t) * 1e3
    if not _same_sample(sub, host_sub):
        raise AssertionError("the DBL-filtered sample differs from the "
                             "host-BFS-filtered one")
    launches = {"verdicts_kernel": dbl_query_verdicts.launches,
                "admit_kernel": bfs_admit_plane.launches}
    if launches["verdicts_kernel"] <= 0:
        raise AssertionError("the DBL server launched no verdicts kernel")

    examples = _finish_examples(*_start_examples(dev, EXAMPLES))
    emit("baselines", card=card, n=n, m=m, k=64, k_prime=64, ip_k=IP_K,
         queries=BASE_QUERIES, inserts=INSERTS,
         checks=dict(dbl_bbfs_ip_equal=True, host_bfs_lanes=checked,
                     mismatches=0, scc_mask_equals_kosaraju=True,
                     sampler_equals_host_bfs=True,
                     examples_ok=sorted(examples)),
         build_ms={"dbl": dbl_build_ms, "ip_lite": ip_build_ms},
         rounds=rounds, dag_stats=dag, dag_stats_s=dag_stats_s,
         scc_condense_numpy_s=condense_s, scc_fwbw_round_ms=fwbw_ms,
         pivot_scc_size=int(scc.sum()),
         sampler=dict(seeds=SAMPLE_SEEDS, fanouts=FANOUTS,
                      targets=targets.tolist(), nodes=int(sub.nodes.size),
                      sampled_edges=sum(int(b.edge_valid.size)
                                        for b in sub.blocks),
                      kept_edges=sum(int(b.edge_valid.sum())
                                     for b in sub.blocks),
                      dbl_ms=sample_ms, host_bfs_ms=host_sample_ms),
         examples=examples, launches=launches,
         wall_s=time.perf_counter() - t_phase)
    return launches


def _hold(what, got, want, tol):
    """Raise unless ``got`` equals ``want`` (same shape and NaN pattern,
    not all NaN) within |got - want| <= rtol |want| + atol max|want|; the
    largest absolute error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or \
            not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{what}: shape or NaN pattern differs")
    ok = ~np.isnan(want)
    if not ok.any():
        raise AssertionError(f"{what}: nothing but NaN")
    scale = float(np.abs(want[ok]).max())
    err = np.abs(got[ok] - want[ok])
    bad = err > tol["rtol"] * np.abs(want[ok]) + tol["atol"] * scale
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.size} "
                             f"values off, up to {err.max()} (max |want| "
                             f"{scale})")
    return float(err.max())


def _gnn_full_batch(rng):
    """``full_graph_sm`` (Cora-sized): uniform random edges, features and
    labels, as CPU tensors."""
    import torch
    from repro_torch.configs.shapes import GNN_SHAPES
    shape = GNN_SHAPES["full_graph_sm"]
    n, m = shape.n_nodes, shape.n_edges
    return {
        "node_feat": torch.as_tensor(
            rng.normal(size=(n, shape.d_feat)).astype(np.float32)),
        "edge_index": torch.as_tensor(np.stack(
            [rng.integers(0, n, m), rng.integers(0, n, m)]).astype(np.int32)),
        "edge_valid": torch.ones(m, dtype=torch.bool),
        "species": torch.zeros(n, dtype=torch.int32),
        "labels": torch.as_tensor(rng.integers(
            0, GNN_CLASSES["full_graph_sm"], n).astype(np.int32)),
    }


def _gnn_molecule_batch(rng):
    """``molecule``: 128 graphs of 30 atoms and their 64 shortest pairs
    (``generators.molecules``) block-diagonal, every DimeNet triplet, and
    a random energy target per graph, as CPU tensors."""
    import torch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.graphs.batching import block_diagonal, graph_ids
    from repro_torch.graphs.generators import molecules
    from repro_torch.models.gnn.common import build_triplets
    shape = GNN_SHAPES["molecule"]
    b, n = shape.batch_graphs, shape.n_nodes
    pos, species, edges = molecules(b, n, shape.n_edges,
                                    seed=int(rng.integers(2**31)))
    ei = block_diagonal(edges, n)
    valid = np.ones(ei.shape[1], bool)
    bound = int(np.bincount(ei[1], minlength=b * n)[ei[0]].sum())
    t_in, t_out, t_val = build_triplets(ei, valid, bound)
    k = int(t_val.sum())
    return {
        "node_feat": None,
        "positions": torch.as_tensor(pos.reshape(-1, 3)),
        "species": torch.as_tensor(species.reshape(-1)),
        "edge_index": torch.as_tensor(ei),
        "edge_valid": torch.as_tensor(valid),
        "graph_ids": torch.as_tensor(graph_ids(b, n)),
        "n_graphs": b,
        "energy_target": torch.as_tensor(
            rng.normal(size=b).astype(np.float32)),
        "triplet_in": torch.as_tensor(t_in[:k]),
        "triplet_out": torch.as_tensor(t_out[:k]),
        "triplet_valid": torch.as_tensor(t_val[:k]),
    }


def _on(batch, dev):
    return {k: v.to(dev) if hasattr(v, "to") else v for k, v in batch.items()}


def _gnn_step(model, batch):
    """The example's step: the loss, its gradients, ``w - 0.05 g``."""
    from repro_torch.models.params import sgd_step
    loss, _ = model.loss_fn(batch)
    loss.backward()
    sgd_step(model, GNN_LR)
    return loss


def _gnn_outputs(model, batch, geometric):
    """What the holds compare: the forward (energies or logits), forces,
    the loss and every parameter's gradient; leaves ``model`` stepped."""
    import torch
    from repro_torch.models.params import grads_to_numpy, sgd_step
    fwd = model.energy if geometric else model.node_logits
    with torch.no_grad():
        out = {"forward": fwd(batch).cpu().numpy()}
    if geometric:
        out["forces"] = model.forces(batch).cpu().numpy()
    loss, _ = model.loss_fn(batch)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = grads_to_numpy(model)
    sgd_step(model, GNN_LR)
    return out


def _gnn_model(name, model, batch_cpu, dev, card, rng):
    """One model of the phase on the card: energy invariance under a
    random rotation (geometric models), its outputs for the holds, the
    forward (and forces) and step times, and one profiled step.  Every
    step starts from the initial parameters (restored after it, untimed:
    at the full configs, ``w - 0.05 g`` steps on these batches diverge
    within three).  (line, card outputs, CPU twin of the module)."""
    import copy

    import torch
    from repro_torch.models.gnn.irreps import random_rotation
    geometric = "positions" in batch_cpu
    cpu_model = copy.deepcopy(model)
    model = model.to(dev)
    batch = _on(batch_cpu, dev)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    line = {"model": name, "card": card,
            "nodes": int(batch_cpu["species"].shape[0]),
            "edges": int(batch_cpu["edge_index"].shape[1])}
    if "triplet_in" in batch_cpu:
        line["triplets"] = int(batch_cpu["triplet_in"].shape[0])
    if geometric:
        R = torch.as_tensor(random_rotation(rng), dtype=torch.float32,
                            device=dev)
        with torch.no_grad():
            e0 = model.energy(batch).cpu().numpy()
            e1 = model.energy({**batch, "positions": batch["positions"]
                               @ R.T}).cpu().numpy()
        line["rotation_max_abs_err"] = _hold(f"{name} energy invariance",
                                             e1, e0, GNN_TOL)
    out = _gnn_outputs(model, batch, geometric)
    model.load_state_dict(initial)
    line["loss"] = out["loss"]
    fwd = model.energy if geometric else model.node_logits
    with torch.no_grad():
        fwd(batch)
        line["forward_ms"] = [_sync_time(lambda: fwd(batch))[1]
                              for _ in range(GNN_REPS)]
    if geometric:
        line["forces_ms"] = [_sync_time(lambda: model.forces(batch))[1]
                             for _ in range(GNN_REPS)]
    line["step_ms"] = []
    for _ in range(GNN_REPS):
        loss, ms = _sync_time(lambda: _gnn_step(model, batch))
        model.load_state_dict(initial)
        if not np.isclose(float(loss.detach()), out["loss"], rtol=1e-4):
            raise AssertionError(f"{name}: a timed step's loss {float(loss)}"
                                 f" is not the first step's {out['loss']}")
        line["step_ms"].append(ms)
    t, t_end, per_kernel = _device_profile(lambda: _gnn_step(model, batch))
    model.load_state_dict(initial)
    line["profiled_step"] = dict(wall_ms=(t_end - t) * 1e3,
                                 **_busy((t_end - t) * 1e3, per_kernel, 5))
    return line, out, cpu_model


def _gnn_hold(name, cpu_model, batch_cpu, want):
    """The CPU twin on the CPU batch against the card's outputs: the
    largest absolute error of each.  The gradients are held as one vector
    (scaled by the largest of all): some parameters' true gradients are 0
    (the last layer's l > 0 mixers), which float32 rounds to noise."""
    got = _gnn_outputs(cpu_model, batch_cpu, "positions" in batch_cpu)
    errs = {k: _hold(f"{name} {k} (card vs CPU)", want[k], got[k],
                     GNN_TOL)
            for k in ("forward", "forces", "loss") if k in got}
    names = sorted(got["grads"])
    errs["grads"] = _hold(
        f"{name} gradients (card vs CPU)",
        np.concatenate([want["grads"][p].ravel() for p in names]),
        np.concatenate([got["grads"][p].ravel() for p in names]), GNN_TOL)
    return errs


def _gnn_minibatch(dev, card, rng):
    """The example's path on the LJ preset at full size: a DBL index
    (k = k' = 64) filters ``minibatch_lg``'s samples (1 024 seeds, fanouts
    15 and 10, the 4 vertices of highest in-degree as targets); PNA's full
    CONFIG (602 features, 41 classes) takes a step on each; 100 edges are
    inserted a round.  Each sample must equal the one a host BFS over the
    index's live edges filters from the same draws."""
    import torch
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.core import DBLIndex, make_graph
    from repro_torch.graphs.generators import table2_graph
    from repro_torch.graphs.sampler import CSR, reachability_filtered_sample
    from repro_torch.models.gnn.pna import PNA

    shape = GNN_SHAPES["minibatch_lg"]
    n, src, dst = table2_graph("LJ", scale=1.0, seed=0)
    m = int(src.size)
    g = make_graph(src, dst, n, m_cap=m + GNN_ROUNDS * INSERTS, device=dev)
    idx, build_ms = _sync_time(lambda: DBLIndex.build(
        g, n_cap=n, k=64, k_prime=64, max_iters=64, check="raise",
        device=dev))
    csr = CSR.from_edges(n, src, dst)
    targets = np.argsort(-np.bincount(dst, minlength=n))[:SAMPLE_TARGETS] \
        .astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    feats = torch.randn((n, shape.d_feat), generator=gen, device=dev)
    labels = torch.randint(0, GNN_CLASSES["minibatch_lg"], (n,),
                           generator=gen, device=dev)
    model = PNA(pna_cfg.CONFIG.scaled(n_classes=GNN_CLASSES["minibatch_lg"]),
                shape.d_feat, seed=int(rng.integers(2**31))).to(dev)
    rounds = []
    for r in range(GNN_ROUNDS):
        seeds = rng.choice(n, shape.batch_nodes, replace=False)
        draw = int(rng.integers(2**31))
        sub, sample_ms = _sync_time(lambda: reachability_filtered_sample(
            csr, seeds, shape.fanout, idx, targets,
            rng=np.random.default_rng(draw)))
        ls, ld = live_edges(idx.graph)
        host = reachability_filtered_sample(
            csr, seeds, shape.fanout, _HostReach(n, ls, ld), targets,
            rng=np.random.default_rng(draw))
        if not _same_sample(sub, host):
            raise AssertionError(f"gnn round {r}: the DBL-filtered sample "
                                 "differs from the host-BFS-filtered one")
        nodes = torch.as_tensor(sub.nodes, device=dev).long()
        batch = {
            "node_feat": feats[nodes],
            "edge_index": torch.as_tensor(np.stack([
                np.concatenate([b.src for b in sub.blocks]),
                np.concatenate([b.dst for b in sub.blocks])]), device=dev),
            "edge_valid": torch.as_tensor(np.concatenate(
                [b.edge_valid for b in sub.blocks]), device=dev),
            "species": torch.zeros(nodes.shape[0], dtype=torch.int32,
                                   device=dev),
            "labels": labels[nodes],
        }
        loss, step_ms = _sync_time(lambda: _gnn_step(model, batch))
        if not torch.isfinite(loss):
            raise AssertionError(f"gnn round {r}: loss {float(loss)}")
        ns = rng.integers(0, n, INSERTS).astype(np.int32)
        nd = rng.integers(0, n, INSERTS).astype(np.int32)
        idx, insert_ms = _sync_time(lambda: idx.insert_edges(
            ns, nd, max_iters=64))
        rounds.append(dict(
            round=r, nodes=int(sub.nodes.size),
            kept_edges=sum(int(b.edge_valid.sum()) for b in sub.blocks),
            sampled_edges=sum(int(b.edge_valid.size) for b in sub.blocks),
            sample_ms=sample_ms, step_ms=step_ms, insert_ms=insert_ms,
            loss=float(loss.detach())))
    emit("gnn_minibatch", card=card, n=n, m=m, k=64, k_prime=64,
         batch_nodes=shape.batch_nodes, fanouts=shape.fanout,
         d_feat=shape.d_feat, targets=targets.tolist(), build_ms=build_ms,
         rounds=rounds, samples_equal_host_bfs=True)


def gnn_phase(dev, card):
    """The GNN family at each model's full CONFIG on the card, each held
    against the same module on the CPU; the example's path on the LJ
    preset; the example twin.  Returns the grid kernels' launches in this
    phase (the sampler's verdicts)."""
    import torch
    from repro_torch.configs import dimenet, mace, nequip, pna
    from repro_torch.kernels.bfs_prune.bfs_prune import bfs_admit_plane
    from repro_torch.kernels.dbl_query.dbl_query import dbl_query_verdicts
    from repro_torch.models.gnn.dimenet import DimeNet
    from repro_torch.models.gnn.mace import MACE
    from repro_torch.models.gnn.nequip import NequIP
    from repro_torch.models.gnn.pna import PNA

    # float32 matmuls on the card, not TF32 (the default, set here because
    # the holds compare float32 on the card with float32 on the CPU)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    full = _gnn_full_batch(rng)
    mol = _gnn_molecule_batch(rng)
    mol_classes = GNN_CLASSES["molecule"]
    models = [
        ("pna", PNA(pna.CONFIG.scaled(
            n_classes=GNN_CLASSES["full_graph_sm"]),
            full["node_feat"].shape[1], seed=1), full),
        ("nequip", NequIP(nequip.CONFIG.scaled(n_classes=mol_classes), 0,
                          seed=2), mol),
        ("mace", MACE(mace.CONFIG.scaled(n_classes=mol_classes), 0, seed=3),
         mol),
        ("dimenet", DimeNet(dimenet.CONFIG.scaled(n_classes=mol_classes),
                            0, seed=4), mol),
    ]
    runs = []
    for name, model, batch in models:
        line, out, cpu_model = _gnn_model(name, model, batch, dev, card, rng)
        emit("gnn_model", **line)
        runs.append((name, cpu_model, batch, out))

    dbl_query_verdicts.launches = 0
    bfs_admit_plane.launches = 0
    _gnn_minibatch(dev, card, rng)
    launches = {"verdicts_kernel": dbl_query_verdicts.launches,
                "admit_kernel": bfs_admit_plane.launches}
    if launches["verdicts_kernel"] <= 0:
        raise AssertionError("the filtered sampler launched no verdicts "
                             "kernel")

    procs = _start_examples(dev, GNN_EXAMPLE)
    try:
        holds = {name: _gnn_hold(name, cpu_model, batch, out)
                 for name, cpu_model, batch, out in runs}
    finally:
        examples = _finish_examples(*procs)
    emit("gnn", card=card, holds_max_abs_err=holds, tolerance=GNN_TOL,
         examples=examples,
         launches=launches, wall_s=time.perf_counter() - t_phase)
    return launches


def _mind_config():
    from repro_torch.configs import mind
    return mind.CONFIG


def _mind_batch(rng, cfg, b, dev):
    """The reference test's batch at the config's sizes: uniform ids, ~80 %
    of the history live, the first slot always."""
    import torch
    mask = (rng.random((b, cfg.hist_len)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return {
        "hist": torch.as_tensor(rng.integers(0, cfg.n_items, (
            b, cfg.hist_len)).astype(np.int32), device=dev),
        "hist_mask": torch.as_tensor(mask, device=dev),
        "target": torch.as_tensor(rng.integers(0, cfg.n_items, b)
                                  .astype(np.int32), device=dev),
        "negatives": torch.as_tensor(rng.integers(0, cfg.n_items, cfg.n_neg)
                                     .astype(np.int32), device=dev),
    }


def _mind_outputs(model, batch):
    """The loss, the small parameters' gradients and the item table's
    gradient on the rows the batch touches (every other row's must be 0):
    numpy, the gradients cleared after."""
    import torch
    loss, _ = model.loss_fn(batch)
    loss.backward()
    rows = torch.unique(torch.cat([batch["hist"].reshape(-1),
                                   batch["target"], batch["negatives"]]))
    g = model.item_embed.grad
    untouched = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
    untouched[rows.long()] = False
    if bool(g[untouched].ne(0).any()):
        raise AssertionError("mind: a row no id touches has a gradient")
    out = {"loss": float(loss.detach()),
           "item_embed_rows": g[rows.long()].cpu().numpy(),
           **{name: p.grad.cpu().numpy()
              for name, p in model.named_parameters()
              if name != "item_embed"}}
    model.zero_grad(set_to_none=True)
    return out


def mind_phase(dev, card):
    """MIND at its full CONFIG on the card (2 097 152 items x 64, a
    512 MiB float32 table): one loss step (forward, backward, SGD) at the
    config's history and negatives, and ``retrieval_scores`` for 16 users
    against 1 000 000 candidates, each held against the same module on
    the CPU; the steps and retrieval timed, one step profiled."""
    import copy

    import torch
    from repro_torch.models.params import sgd_step
    from repro_torch.models.recsys.mind import MIND

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = _mind_config()
    rng = np.random.default_rng(11)
    torch.cuda.reset_peak_memory_stats()
    model = MIND(cfg, seed=11, device=dev)
    cpu_model = copy.deepcopy(model).cpu()
    batch = _mind_batch(rng, cfg, MIND_BATCH, dev)
    users = _mind_batch(rng, cfg, MIND_USERS, dev)
    cands = torch.as_tensor(rng.integers(0, cfg.n_items, MIND_CANDIDATES)
                            .astype(np.int32), device=dev)

    out = _mind_outputs(model, batch)
    with torch.no_grad():
        scores = model.retrieval_scores(users["hist"], users["hist_mask"],
                                        cands)
        _sync_time(lambda: model.retrieval_scores(
            users["hist"], users["hist_mask"], cands))
        retrieval_ms = [_sync_time(lambda: model.retrieval_scores(
            users["hist"], users["hist_mask"], cands))[1]
            for _ in range(MIND_REPS)]

    def step():
        loss, _ = model.loss_fn(batch)
        loss.backward()
        sgd_step(model, MIND_LR)
        return loss
    step()
    step_ms, losses = [], []
    for _ in range(MIND_REPS):
        loss, ms = _sync_time(step)
        step_ms.append(ms)
        losses.append(float(loss.detach()))
    if not np.isfinite(losses).all():
        raise AssertionError(f"mind: step losses {losses}")
    t, t_end, per_kernel = _device_profile(step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    want = _mind_outputs(cpu_model, cpu_batch)
    holds = {k: _hold(f"mind {k} (card vs CPU)", out[k], want[k], GNN_TOL)
             for k in want}
    with torch.no_grad():
        holds["retrieval"] = _hold(
            "mind retrieval (card vs CPU)", scores.cpu().numpy(),
            cpu_model.retrieval_scores(users["hist"].cpu(),
                                       users["hist_mask"].cpu(),
                                       cands.cpu()).numpy(), GNN_TOL)
    # the least bytes retrieval moves: the candidates' ids and rows once,
    # the (users, candidates) scores once
    d = cfg.embed_dim
    retrieval_bytes = MIND_CANDIDATES * (4 + 4 * d) + \
        MIND_USERS * MIND_CANDIDATES * 4
    emit("mind", card=card, n_items=cfg.n_items, embed_dim=d,
         n_interests=cfg.n_interests, capsule_iters=cfg.capsule_iters,
         batch=MIND_BATCH, hist_len=cfg.hist_len, n_neg=cfg.n_neg,
         users=MIND_USERS, candidates=MIND_CANDIDATES,
         table_mib=cfg.n_items * d * 4 / 2 ** 20,
         step_ms=step_ms, losses=losses, retrieval_ms=retrieval_ms,
         retrieval_bytes_bound_ms=retrieval_bytes / PEAK_BYTES_PER_S * 1e3,
         profiled_step=dict(wall_ms=(t_end - t) * 1e3,
                            **_busy((t_end - t) * 1e3, per_kernel, 5)),
         peak_memory_gb=peak_gb, holds_max_abs_err=holds,
         tolerance=GNN_TOL, wall_s=time.perf_counter() - t_phase)


def _lm_config(module, layers):
    """A config of ``configs/`` at full width, cut to ``layers`` layers
    (None keeps them all)."""
    import importlib
    cfg = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    return cfg if layers is None else cfg.scaled(n_layers=layers)


def _no_drop(cfg):
    """The config with every MoE slot inside the capacity
    (capacity_factor 2 E / K gives C >= 2 T): a forward over many tokens
    then routes as decode over few does, as the reference's SMOKE configs
    set it (capacity_factor 8) for the same check."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return cfg.scaled(moe=dataclasses.replace(
        cfg.moe, capacity_factor=2 * cfg.moe.n_experts / cfg.moe.top_k))


def _allclose(what, got, want, tol):
    """Raise unless |got - want| <= atol + rtol |want| elementwise (the
    reference test's assert_allclose); the largest absolute error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    if got.shape != want.shape or not np.isfinite(got).all() or \
            (err > tol["atol"] + tol["rtol"] * np.abs(want)).any():
        raise AssertionError(f"{what}: off by up to {err.max()} "
                             f"(shapes {got.shape}, {want.shape})")
    return float(err.max())


def _f32(x):
    return x.detach().float().cpu().numpy()


def _lm_self_check(model, cfg, rng, dev, long=None):
    """In float32 compute without drops: prefill(S) then ``decode_step``
    at S against the forward on S + 1 tokens (the reference test's check
    and tolerances).  ``long=(s, s_full)``: prefill s tokens, decode at
    s, against the forward on s_full tokens at s (gemma2 past its
    window); batch 1 there.  Largest errors.

    The weights are converted to float32 storage first (the same values:
    a bfloat16 weight cast at use), so that no layer casts its whole
    expert stack at once (arctic's would not fit beside it)."""
    import torch
    from repro_torch.models.transformer.model import _unembed
    torch.cuda.empty_cache()
    model.float()
    model.cfg = _no_drop(cfg.scaled(dtype="float32"))
    s, s_full, b = (LM_PROMPT, LM_PROMPT + 1, LM_BATCH) if long is None \
        else (*long, 1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s_full))
                          .astype(np.int32), device=dev)
    with torch.no_grad():
        x, _ = model.forward_hidden(tok)
        full = _unembed(model.params, model.cfg, x[:, s - 1:s + 1])
        del x
        last, cache = model.prefill(tok[:, :s], s + 1)
        dec, _ = model.decode_step(cache, tok[:, s], s)
    del cache
    return {"prefill": _allclose("prefill vs forward", _f32(last),
                                 _f32(full[:, 0]), LM_PREFILL_TOL),
            "decode": _allclose("decode vs forward", _f32(dec),
                                _f32(full[:, 1]), LM_DECODE_TOL)}


def _lm_cpu_outputs(model, prompts, ids, tok, tgt):
    """What the card-against-CPU holds compare, in float32 compute: the
    prefill's last logits, ``LM_CPU_STEPS`` decode steps fed ``ids``
    (the card's greedy ids) and the loss on (tok, tgt)."""
    import torch
    from repro_torch.serve.decode import serve_step
    with torch.no_grad():
        last, cache = model.prefill(prompts, LM_PROMPT + LM_CPU_STEPS)
        out = {"prefill": _f32(last)}
        for i in range(LM_CPU_STEPS):
            logits, cache = serve_step(model, cache, ids[:, i],
                                       LM_PROMPT + i)
            out[f"decode_{i}"] = _f32(logits)
        out["loss"] = float(model.loss_fn(tok, tgt)[0])
    return out


def _lm_run(name, module, layers, dev, card, rng):
    """One config of the lm phase; its line."""
    import copy

    import torch
    from repro_torch.models.params import sgd_step
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.serve.decode import generate, serve_step

    t_run = time.perf_counter()
    cfg = _lm_config(module, layers)
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, seed=21, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    line = {"model": name, "card": card, "layers": cfg.n_layers,
            "layers_cut_from": None if layers is None
            else _lm_config(module, None).n_layers,
            "params": n_params,
            "param_gb": sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9,
            "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "batch": LM_BATCH, "prompt": LM_PROMPT, "steps": LM_STEPS}
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (
        LM_BATCH, LM_PROMPT)).astype(np.int32), device=dev)
    with torch.no_grad():
        model.prefill(prompts, LM_PROMPT + LM_STEPS)
        line["prefill_ms"] = [_sync_time(lambda: model.prefill(
            prompts, LM_PROMPT + LM_STEPS))[1] for _ in range(LM_REPS)]
        _, cache = model.prefill(prompts, LM_PROMPT + LM_STEPS)
        tok0 = prompts[:, -1]
        serve_step(model, cache, tok0, LM_PROMPT)
        line["decode_step_ms"] = [_sync_time(lambda: serve_step(
            model, cache, tok0, LM_PROMPT))[1] for _ in range(LM_REPS)]
        t, t_end, per_kernel = _device_profile(
            lambda: serve_step(model, cache, tok0, LM_PROMPT))
        line["profiled_decode_step"] = dict(
            wall_ms=(t_end - t) * 1e3,
            **_busy((t_end - t) * 1e3, per_kernel, 5))
        del cache
    ids, gen_ms = _sync_time(lambda: generate(model, prompts, LM_STEPS))
    line["generate_ms"] = gen_ms
    line["greedy_tokens_per_s"] = LM_BATCH * LM_STEPS / (gen_ms / 1e3)
    if ids.shape != (LM_BATCH, LM_STEPS) or \
            not bool(((ids >= 0) & (ids < cfg.vocab)).all()):
        raise AssertionError(f"{name}: generated ids {tuple(ids.shape)}")
    line["sample_ids"] = ids[0, :8].tolist()
    if cfg.layer_pattern != "local_global" and layers is None:
        long = torch.as_tensor(rng.integers(0, cfg.vocab, (
            LM_BATCH, LM_LONG)).astype(np.int32), device=dev)
        with torch.no_grad():
            model.prefill(long, LM_LONG)
            line["long_prefill"] = dict(
                shape=[LM_BATCH, LM_LONG], ms=[_sync_time(
                    lambda: model.prefill(long, LM_LONG))[1]
                    for _ in range(2)])
        del long

    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (
        LM_BATCH, LM_TRAIN_SEQ + 1)).astype(np.int32), device=dev)
    tok, tgt = tok[:, :-1], tok[:, 1:]

    def step():
        loss, _ = model.loss_fn(tok, tgt)
        loss.backward()
        sgd_step(model, LM_LR)
        return loss
    step()
    line["sgd_step_ms"], losses = [], []
    for _ in range(LM_REPS):
        loss, ms = _sync_time(step)
        line["sgd_step_ms"].append(ms)
        losses.append(float(loss.detach()))
    t, t_end, per_kernel = _device_profile(step)
    line["profiled_sgd_step"] = dict(
        wall_ms=(t_end - t) * 1e3, **_busy((t_end - t) * 1e3, per_kernel, 5))
    line["sgd_seq"], line["sgd_losses"] = LM_TRAIN_SEQ, losses
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: step losses {losses}")

    line["self_check_max_abs_err"] = _lm_self_check(model, cfg, rng, dev)
    if cfg.layer_pattern == "local_global":
        line["past_window"] = dict(
            window=cfg.window, prefill=GEMMA_LONG[0], forward=GEMMA_LONG[1],
            max_abs_err=_lm_self_check(model, cfg, rng, dev, GEMMA_LONG))
    if layers is None:
        # float32 compute on the card against the same module on the CPU
        model.cfg = cfg.scaled(dtype="float32")
        with torch.no_grad():
            ids32 = generate(model, prompts, LM_CPU_STEPS)
        got = _lm_cpu_outputs(model, prompts, ids32, tok, tgt)
        cpu_model = copy.deepcopy(model).cpu()
        want = _lm_cpu_outputs(cpu_model, prompts.cpu(), ids32.cpu(),
                               tok.cpu(), tgt.cpu())
        line["cpu_holds_max_abs_err"] = {
            k: _hold(f"{name} {k} (card vs CPU)", got[k], want[k], GNN_TOL)
            for k in want}
        del cpu_model
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    line["wall_s"] = time.perf_counter() - t_run
    del model
    torch.cuda.empty_cache()
    return line


def lm_phase(dev, card):
    """The transformer family at full width on the card (``LM_RUNS``):
    prefill, decode steps, greedy tokens/s and an SGD step timed in the
    config's dtype, device busy shares from a profiled decode step and SGD
    step, self-consistency of prefill and decode against the forward in
    float32 (gemma2 also past its window), tinyllama and qwen held
    against the CPU; the example twin beside it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    procs = _start_examples(dev, LM_EXAMPLE)
    try:
        for name, module, layers in LM_RUNS:
            emit("lm_model", **_lm_run(name, module, layers, dev, card, rng))
    finally:
        examples = _finish_examples(*procs)
    emit("lm", card=card, models=[r[0] for r in LM_RUNS],
         cuts={name: layers for name, _, layers in LM_RUNS if layers},
         prefill_tolerance=LM_PREFILL_TOL, decode_tolerance=LM_DECODE_TOL,
         cpu_tolerance=GNN_TOL, examples=examples,
         wall_s=time.perf_counter() - t_phase)


def _leaf_err(what, got, want, tol):
    """Raise unless the leaves of two trees agree elementwise, compared
    on ``got``'s device: |got - want| <= atol + rtol |want|, a bfloat16
    leaf within two bfloat16 ulps of ``want`` plus half an ulp of the
    leaf's largest (tests/test_torch_train_loop.py's rule: a weight
    updated to near zero cancels, and its float32 error is an ulp of the
    operands, not of the result); the largest absolute error."""
    import torch
    from repro_torch.models.params import tree_leaves
    got, want = tree_leaves(got), tree_leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} leaves for {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.to(g.device)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} leaf {i}: {g.dtype} {g.shape} "
                                 f"for {w.dtype} {w.shape}")
        err = (g.float() - w.float()).abs()
        if w.dtype == torch.bfloat16:
            wf = w.float().abs()
            bound = 2.0 ** -6 * wf + 2.0 ** -9 * wf.max()
        else:
            bound = tol["atol"] + tol["rtol"] * w.float().abs()
        if not bool(torch.isfinite(g.float()).all()) or \
                not bool((err <= bound).all()):
            raise AssertionError(f"{what} leaf {i}: "
                                 f"{int((err > bound).sum())} of "
                                 f"{err.numel()} off, up to "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def _same_state(a, b):
    """Bit for bit over every leaf of two states: {equal, leaves that
    differ, largest absolute difference}."""
    import torch
    from repro_torch.models.params import tree_leaves
    differ, worst = 0, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            same = torch.equal(x, y)
            if not same:
                worst = max(worst, float((x.float() - y.float()).abs()
                                         .max()))
        else:
            same = np.array_equal(x, y)
        differ += not same
    return {"equal": differ == 0, "leaves_differing": differ,
            "max_abs_diff": worst}


def _update_hold(opt, params, opt_state, gen, dev):
    """The optimizer update on the card against the same update on the
    CPU, from the same parameters, state and random gradients (normal at
    scale 1e-3, in each parameter's dtype), at ``TRAIN_OPT_TOL``, with a
    rate (``TRAIN_HOLD_LR``) that moves every weight by far more than the
    tolerance: the largest errors of the parameters and of the state
    trees, and the CPU update's seconds."""
    import torch
    from repro_torch.models.params import tree_map
    from repro_torch.train.optim import OPTIMIZERS
    _, upd = OPTIMIZERS[opt]
    grads = tree_map(lambda p: (torch.randn(
        p.shape, generator=gen, device=dev) * 1e-3).to(p.dtype), params)
    got_p, got_s = upd(grads, opt_state, params, lr=TRAIN_HOLD_LR)

    def cpu(tree):
        return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                        else x, tree)
    t = time.perf_counter()
    want_p, want_s = upd(cpu(grads), cpu(opt_state), cpu(params),
                         lr=TRAIN_HOLD_LR)
    cpu_s = time.perf_counter() - t
    return {"params": _leaf_err(f"{opt} update params (card vs CPU)",
                                got_p, want_p, TRAIN_OPT_TOL),
            "state": _leaf_err(f"{opt} update state (card vs CPU)",
                               got_s[:2], want_s[:2], TRAIN_OPT_TOL),
            "cpu_update_s": cpu_s}


def _accum_hold(model, cfg, state, sched, batch):
    """In float32 compute: one step at accum 2 (2 x 2 x 128) against one
    at accum 1 on the same 4 x 128 tokens from the same state, the
    reference test's check and tolerance; the largest errors."""
    from repro_torch.train.loop import lm_loss, make_train_step
    model.cfg = cfg.scaled(dtype="float32")
    try:
        kw = dict(optimizer=cfg.optimizer, lr_schedule=sched, donate=False)
        two = make_train_step(lm_loss(model), accum=2, **kw)
        one = make_train_step(lm_loss(model), **kw)
        a, ma = two(state, {k: v.reshape(2, TRAIN_BATCH // 2, -1)
                            for k, v in batch.items()})
        b, mb = one(state, batch)
        return {"params": _leaf_err("accum 2 vs 1 params", a.params,
                                    b.params, TRAIN_STEP_TOL),
                "loss": abs(float(ma["loss"]) - float(mb["loss"])),
                "lr": float(ma["lr"])}
    finally:
        model.cfg = cfg


def _train_run(name, module, layers, dev, card, before_holds=None):
    """One config of the train phase; its line.  ``before_holds`` runs
    after the timed steps and before the holds."""
    import statistics

    import torch
    from repro_torch.core._threefry import seed_key
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train.data import lm_batches
    from repro_torch.train.loop import init_state, lm_loss, make_train_step
    from repro_torch.train.optim import OPTIMIZERS, cosine_schedule

    t_run = time.perf_counter()
    cfg = _lm_config(module, layers)
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, seed=22, device=dev)
    state = init_state(seed_key(22), model.params, cfg.optimizer)
    sched = cosine_schedule(**TRAIN_SCHEDULE)
    step_fn = make_train_step(lm_loss(model), optimizer=cfg.optimizer,
                              lr_schedule=sched)
    data = lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=22, device=dev)
    line = {"model": name, "card": card, "layers": cfg.n_layers,
            "layers_cut_from": None if layers is None
            else _lm_config(module, None).n_layers,
            "params": sum(p.numel() for p in model.parameters()),
            "param_gb": sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9,
            "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "optimizer": cfg.optimizer, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "schedule": TRAIN_SCHEDULE,
            "warmup_steps": TRAIN_WARMUP}
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        batch = next(data)
        (state, metrics), ms = _sync_time(lambda: step_fn(state, batch))
        losses.append(float(metrics["loss"]))
        if i >= TRAIN_WARMUP:
            step_ms.append(ms)
    line["step_ms"] = step_ms
    line["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (
        statistics.median(step_ms) / 1e3)
    acc_fn = make_train_step(lm_loss(model), optimizer=cfg.optimizer,
                             lr_schedule=sched, accum=2)
    acc_data = lm_batches(cfg, TRAIN_BATCH // 2, TRAIN_SEQ, seed=23,
                          accum=2, device=dev)
    line["accum2_step_ms"] = []
    for _ in range(TRAIN_ACCUM_STEPS):
        batch = next(acc_data)
        (state, metrics), ms = _sync_time(lambda: acc_fn(state, batch))
        losses.append(float(metrics["loss"]))
        line["accum2_step_ms"].append(ms)
    batch = next(data)
    box = {}
    t, t_end, per_kernel = _device_profile(
        lambda: box.update(out=step_fn(state, batch)))
    state = box.pop("out")[0]
    line["profiled_step"] = dict(wall_ms=(t_end - t) * 1e3,
                                 **_busy((t_end - t) * 1e3, per_kernel, 5))
    line["losses"] = losses
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: step losses {losses}")
    if before_holds is not None:
        before_holds()

    gen = torch.Generator(device=dev).manual_seed(22)
    holds = {}
    if cfg.optimizer == "adamw":
        holds["accum2_vs_accum1"] = _accum_hold(model, cfg, state, sched,
                                                next(data))
        holds["update_card_vs_cpu"] = _update_hold(
            cfg.optimizer, state.params, state.opt_state, gen, dev)
    else:   # the attention leaves: factored bf16 matrices, float32 norms
        def attn(tree):
            return {"layers": {"attn": tree["layers"]["attn"]}}
        st = state.opt_state
        holds["update_card_vs_cpu_attn"] = _update_hold(
            cfg.optimizer, attn(state.params),
            type(st)(attn(st[0]), attn(st[1]), st.step), gen, dev)
    line["holds_max_abs_err"] = holds
    line["hold_tolerances"] = dict(
        step=TRAIN_STEP_TOL, update=TRAIN_OPT_TOL, update_lr=TRAIN_HOLD_LR,
        bf16="2 ulps of the value + half an ulp of the leaf's largest")
    torch.cuda.empty_cache()

    _, upd = OPTIMIZERS[cfg.optimizer]
    grads = tree_map(lambda p: (torch.randn(
        p.shape, generator=gen, device=dev) * 1e-3).to(p.dtype),
        state.params)
    line["update_ms"] = []
    for _ in range(TRAIN_UPDATE_REPS):
        (_, opt_state), ms = _sync_time(lambda: upd(
            grads, state.opt_state, state.params, lr=1e-4, inplace=True))
        state = state._replace(opt_state=opt_state)
        line["update_ms"].append(ms)
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    line["wall_s"] = time.perf_counter() - t_run
    del model, state, grads
    torch.cuda.empty_cache()
    return line


def restart_child(argv):
    """The kill-and-restart check at full width, in its own process:
    ``python -c 'import sys, chip_smoke; chip_smoke.restart_child(
    sys.argv[1:])' <out.json> <device> <config as JSON> <dir>``, with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts.  First the
    same step from the same state twice, with the default algorithms and
    with deterministic ones (the latter must give the same bits); then,
    deterministic: 3 steps, ``save`` (async, then blocking, timed), 3
    more; ``restore`` (timed) and the last 3 replayed, every leaf equal
    to the first run's bit for bit (tests/test_train_substrate.py's
    check).  Writes its line to ``<out.json>``."""
    import os

    import torch
    from repro_torch.configs.base import MoEConfig, TransformerConfig
    from repro_torch.core._threefry import seed_key
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import lm_batches
    from repro_torch.train.loop import init_state, lm_loss, make_train_step
    from repro_torch.train.optim import cosine_schedule

    out_path, device, cfg_json, root = argv
    dev = torch.device(device)
    fields = json.loads(cfg_json)
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    cfg = TransformerConfig(**fields)
    timed = _sync_time if dev.type == "cuda" else _host_time
    model = Transformer(cfg, seed=23, device=dev)
    state = init_state(seed_key(7), model.params, cfg.optimizer)
    step_fn = make_train_step(lm_loss(model), optimizer=cfg.optimizer,
                              lr_schedule=cosine_schedule(**RESTART_SCHEDULE),
                              donate=False)
    data = lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=3, device=dev)
    batches = [next(data) for _ in range(6)]
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "optimizer": cfg.optimizer, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "schedule": RESTART_SCHEDULE}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        a, _ = step_fn(state, batches[0])
        b, _ = step_fn(state, batches[0])
        res[f"same_step_same_bits_{mode}"] = _same_state(a, b)
        del a, b
    if not res["same_step_same_bits_deterministic"]["equal"]:
        raise AssertionError(f"a step is not reproducible under "
                             f"deterministic algorithms: {res}")
    s = state
    for b in batches[:3]:
        s, _ = step_fn(s, b)
    ck = os.path.join(root, "restart")
    writer, res["async_save_return_ms"] = timed(
        lambda: ckpt.save(s, ck, 3, blocking=False))
    t = time.perf_counter()
    writer.join()
    res["async_save_total_ms"] = res["async_save_return_ms"] + (
        time.perf_counter() - t) * 1e3
    shutil.rmtree(ck)
    _, res["save_ms"] = timed(lambda: ckpt.save(s, ck, 3))
    res["bytes_written"] = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, files in os.walk(ck) for f in files)
    ref = s
    for b in batches[3:]:
        ref, _ = step_fn(ref, b)
    restored, res["restore_ms"] = timed(lambda: ckpt.restore(ck, s))
    if int(restored.step) != 3:
        raise AssertionError(f"restored step {restored.step}")
    s2 = restored
    for b in batches[3:]:
        s2, _ = step_fn(s2, b)
    res["restart"] = _same_state(s2, ref)
    shutil.rmtree(ck)
    if not res["restart"]["equal"]:
        raise AssertionError(f"restart is not bitwise: {res['restart']}")
    with open(out_path, "w") as f:
        json.dump(res, f)


def _start_restart_child(dev, tmp):
    """Start ``restart_child`` on ``RESTART_RUN``'s config: (proc,
    out path)."""
    import dataclasses
    import os
    _, module, layers = RESTART_RUN
    cfg = _lm_config(module, layers)
    out = os.path.join(tmp, "restart.json")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.restart_child(sys.argv[1:])", out, dev.type,
         json.dumps(dataclasses.asdict(cfg)), tmp],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, out


def train_phase(dev, card):
    """The training path (``repro_torch.train``, ``launch/train.py``) at
    full width on the card (``TRAIN_RUNS``): timed steps, accum-2 steps,
    a profiled step and the optimizer update alone, the holds; the
    kill-and-restart check on ``RESTART_RUN`` in a subprocess; the
    example twin and the launcher (then ``--resume``) as subprocesses."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="train_phase_")
    started = {}

    def start_children():
        started["restart"] = _start_restart_child(dev, tmp)
        started["examples"] = _start_examples(dev, {
            "train_lm_torch": ("examples/train_lm_torch.py", "--steps",
                               "50", "--ckpt-dir", f"{tmp}/twin"),
            "launch_train": _launch_args(tmp)})
    try:
        for i, (name, module, layers) in enumerate(TRAIN_RUNS[::-1]):
            emit("train_model", **_train_run(
                name, module, layers, dev, card,
                start_children if i == len(TRAIN_RUNS) - 1 else None))
        examples = _finish_examples(*started.pop("examples"), endings={
            "train_lm_torch": "final checkpoint at step 50",
            "launch_train": "done at step 4"})
        examples.update(_finish_examples(*_start_examples(dev, {
            "launch_train_resume": _launch_args(tmp) + ("--resume",)}),
            endings={"launch_train_resume": "done at step 8"}))
        if "resumed from step 4" not in \
                examples["launch_train_resume"]["last_lines"]:
            raise AssertionError(f"the launcher did not resume: "
                                 f"{examples['launch_train_resume']}")
        proc, out = started.pop("restart")
        stdout, stderr = proc.communicate(timeout=TRAIN_CHILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"the restart check failed (rc "
                                 f"{proc.returncode}): {stdout[-1000:]} "
                                 f"{stderr[-3000:]}")
        with open(out) as f:
            emit("train_restart", card=card, **json.load(f))
        emit("train", card=card,
             models=[r[0] for r in TRAIN_RUNS] + [RESTART_RUN[0]],
             cuts={name: layers for name, _, layers in TRAIN_RUNS
                   if layers}, examples=examples,
             wall_s=time.perf_counter() - t_phase)
    finally:
        left = [started["restart"][0]] if "restart" in started else []
        if "examples" in started:
            left += list(started["examples"][0].values())
        for proc in left:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------- moe_sharded, train_sharded
def _mesh_config(run, module, layers=None):
    """``module``'s CONFIG (or SMOKE under ``run["smoke"]``, the CPU
    rehearsal), cut to ``layers`` layers."""
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    cfg = mod.SMOKE if run["smoke"] else mod.CONFIG
    return cfg if layers is None else cfg.scaled(n_layers=layers)


def _clock(dev, fn):
    return _sync_time(fn) if dev.type == "cuda" else _host_time(fn)


def _peak_gb(dev):
    import torch
    if dev.type != "cuda":
        return "not measured"
    return torch.cuda.max_memory_allocated() / 1e9


def _reset_peak(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _rel_hold(what, got, want, tol):
    """Raise unless |got - want| <= rtol |want| + frac max|want|
    elementwise (``tol = (rtol, frac)``); the largest absolute error."""
    import torch
    got, want = got.detach().float(), want.detach().float().to(got.device)
    rtol, frac = tol
    err = (got - want).abs()
    bound = rtol * want.abs() + frac * want.abs().max()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
            or not bool((err <= bound).all()):
        raise AssertionError(f"{what}: {int((err > bound).sum())} of "
                             f"{err.numel()} off, up to {float(err.max())}")
    return float(err.max())


def moe_sharded_run(mesh, dev, run, rank):
    """One rank's part of the ``moe_sharded`` phase on ``mesh``: the MoE of
    ``run["module"]`` at full width (bf16 weights drawn from a seed on
    every rank, each keeping its experts; ``run["moe_tokens"]`` tokens of
    which the rank holds block ``i n_tp + j``) in the no-drop regime.
    Times (bf16, aux weight as configured): the forward, the forward and
    backward of the rank's share of ``mean(y^2) + aux``, and the
    all-to-all of the rank's buffer alone.  Holds, in float32 with aux
    weight 0: ``y`` and every gradient (summed over the ranks as
    ``make_train_step(state_shardings=)`` sums them) against the local
    ``moe_ffn`` on the whole batch, which each rank computes in turn;
    ``aux`` (bf16 run) against the per-cell estimator from ``route``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.launch.sharding import Layout, P
    from repro_torch.models.transformer.model import _act
    from repro_torch.models.transformer.moe import (_counts, init_moe_params,
                                                    moe_ffn, route)
    from repro_torch.models.transformer.moe_sharded import (
        exchange, local_experts, moe_ffn_sharded)

    cfg = _no_drop(_mesh_config(run, run["module"]))
    moe, d, act = cfg.moe, cfg.d_model, _act(cfg.act)
    e, k, t = moe.n_experts, moe.top_k, run["moe_tokens"]
    n, n_tp = mesh.size, mesh.sizes["model"]
    cell = mesh.coord("data") * n_tp + mesh.coord("model")
    blk = t // n
    experts = ("w1", "w2", "w3")
    whole = Layout(mesh, P())

    def draw():
        gen = torch.Generator(device=dev).manual_seed(16)
        p = init_moe_params(gen, d, moe, torch.bfloat16, device=dev)
        x = (torch.randn(t, d, generator=gen, device=dev)
             ).to(torch.bfloat16)
        return p, x

    def share_grads(p, xb, moe_):
        leaves = {name: v.detach().requires_grad_() for name, v in p.items()}
        y, aux = moe_ffn_sharded(leaves, xb, moe_, act, mesh=mesh,
                                 dp_axes=("data",), tp_axis="model")
        share = (y.float() ** 2).sum() / (t * d) + aux / n
        g = torch.autograd.grad(share, list(leaves.values()))
        return y.detach(), aux.detach(), dict(zip(leaves, g))

    t_run = time.perf_counter()
    _reset_peak(dev)
    full, x = draw()
    local = {name: local_experts(v, e, mesh, "model").clone()
             if name in experts else v for name, v in full.items()}
    del full
    xb = x[cell * blk:(cell + 1) * blk]
    res = {"rank": rank, "coords": list(mesh.coords),
           "tokens_per_rank": blk, "experts_per_rank": e // n_tp}

    def fwd():
        with torch.no_grad():
            return moe_ffn_sharded(local, xb, moe, act, mesh=mesh,
                                   dp_axes=("data",), tp_axis="model")
    fwd()
    res["fwd_ms"] = [_clock(dev, fwd)[1] for _ in range(MOE_REPS)]
    share_grads(local, xb, moe)
    res["fwd_bwd_ms"] = []
    for _ in range(MOE_REPS):
        (_, aux, _), ms = _clock(dev, lambda: share_grads(local, xb, moe))
        res["fwd_bwd_ms"].append(ms)
    c = max(4, int(blk * k / e * moe.capacity_factor))
    buf = torch.zeros(n_tp, e // n_tp, c, d, dtype=torch.bfloat16,
                      device=dev)
    res["capacity_per_rank"] = c
    res["a2a_bytes_per_rank"] = buf.numel() * 2 * (n_tp - 1) // n_tp
    res["a2a_per_fwd_bwd"] = 4 if n_tp > 1 else 0
    res["a2a_ms"] = [_clock(dev, lambda: exchange(buf, mesh, "model"))[1]
                     for _ in range(MOE_REPS)] if n_tp > 1 else []
    del buf
    cells_aux = []
    for cb in x.float().chunk(n):
        r = route(local, cb, moe, capacity=max(4, int(blk * k / e
                                                      * moe.capacity_factor)))
        f_e = _counts(r["se"], e).to(torch.float32) / (blk * k)
        cells_aux.append(moe.router_aux_weight * e
                         * torch.sum(f_e * r["probs"].mean(dim=0)))
    want_aux = torch.stack(cells_aux).mean()
    res["aux"] = float(aux)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)

    hold_moe = dataclasses.replace(moe, router_aux_weight=0.0)
    y, _, g = share_grads({name: v.float() for name, v in local.items()},
                          xb.float(), hold_moe)
    for name in g:
        g[name] = whole.psum(g[name], ("data",) if name in experts
                             else mesh.axis_names)
    res["peak_memory_gb"] = _peak_gb(dev)
    del local
    _reset_peak(dev)
    holds = {}
    for turn in range(n):
        if turn == rank:
            ref, _ = draw()
            ref = {name: v.float().requires_grad_() for name, v in
                   ref.items()}
            y_ref, _ = moe_ffn(ref, x.float(), hold_moe, act, capacity=t)
            loss = (y_ref ** 2).sum() / (t * d)
            g_ref = dict(zip(ref, torch.autograd.grad(loss,
                                                      list(ref.values()))))
            holds["y"] = _rel_hold("moe y", y, y_ref[cell * blk:
                                                     (cell + 1) * blk],
                                   MOE_Y_TOL)
            for name, want in g_ref.items():
                if name in experts:
                    want = local_experts(want, e, mesh, "model")
                holds[f"grad_{name}"] = _rel_hold(f"moe grad {name}",
                                                  g[name], want,
                                                  MOE_GRAD_TOL)
            del ref, y_ref, g_ref, loss
            _reset_peak(dev)
        if n > 1:
            dist.barrier()
    res["holds_max_abs_err"] = holds
    _reset_peak(dev)
    res["wall_s"] = time.perf_counter() - t_run
    return res


def _routing(probs, eidx, c):
    """``moe.route``'s slots for the given top-k experts ``eidx`` (T, K)
    instead of its own ``topk``: the gates read from ``probs``."""
    import torch
    from repro_torch.models.transformer.moe import _counts
    t, k = eidx.shape
    gates = probs.gather(1, eidx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    slot_e = eidx.reshape(-1)
    order = torch.argsort(slot_e, stable=True)
    se = slot_e[order]
    counts = _counts(se, probs.shape[1])
    pos = torch.arange(t * k, device=probs.device) - (
        torch.cumsum(counts, 0) - counts)[se]
    return dict(c=c, probs=probs, order=order, se=se, tok=order // k,
                gate=gates.reshape(-1)[order], pos=pos, keep=pos < c)


def _top_margin(probs, k):
    """Per token: the smallest gap between neighbours among its k + 1
    largest router probabilities (how near its top k is to a tie)."""
    import torch
    top = torch.topk(probs, k + 1).values
    return (top[:, :-1] - top[:, 1:]).min(dim=1).values


def _capturing(opt, box):
    """``OPTIMIZERS[opt]`` with an update that first keeps its gradients
    in ``box`` (once)."""
    from repro_torch.train.optim import OPTIMIZERS
    init, update = OPTIMIZERS[opt]

    def capture(grads, *args, **kw):
        if not box:
            box.append(grads)
        return update(grads, *args, **kw)
    return init, capture


def train_sharded_run(mesh, dev, run, rank):
    """One rank's part of the ``train_sharded`` phase on a (2, 2) mesh:
    ``run["module"]`` at full width cut to ``run["train_layers"]`` layers,
    ``moe_impl="shard_map"``, no drops, aux weight 0, float32 compute and
    weights, its Adafactor; the state drawn from a seed, each rank keeping
    its shards; ``TRAIN_SHARDED_STEPS`` steps on 4 x 128 tokens, each rank
    feeding its data block.  Held on rank 0, on the same card, after the
    first step: the gradients the sharded step reduced against the
    single-process step's (``TRAIN_SHARDED_GRAD_TOL``), and the sharded
    step's parameters against the single-process Adafactor update of the
    same state by those gradients (``TRAIN_STEP_TOL``).

    Why float32 weights (the config stores bfloat16): a bfloat16 gradient
    is each rank's partial rounded to bfloat16, then summed, and where the
    partials cancel that differs from the single process's one rounding
    by more than the bfloat16 rule (the CPU rehearsal at SMOKE size: 1 of
    16 384 embedding gradients off by 3.9e-3).  Why not the
    single-process step's parameters: Adafactor's first update of an
    expert that few tokens reach (a gradient of rank one or two) is the
    sign of each element, so an element whose gradient is rounding noise
    moves by a whole rate either way (measured: 42 of 369 M ``w2``
    weights, up to 0.18 of the rate), and an expert that no token reaches
    gets a router column of noise normalized to a full update.
    Why the routing is replayed: top-k routing is not continuous, and the
    ranks' products run on other shapes, so logits an ulp apart can swap a
    token's experts at a near tie.  The sharded run's first forward
    records each layer's top-k experts and the single-process step routes
    its tokens to them; a token whose own top k differs must sit within
    ``ROUTING_TIE`` of a tie, and the line counts them."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core._threefry import seed_key
    from repro_torch.launch.cells import lm_constrain
    from repro_torch.launch.sharding import (lm_batch_shardings,
                                             lm_state_shardings, shard_tree,
                                             tree_map_with_path)
    from repro_torch.models.params import (tree_leaves, tree_map,
                                           tree_unflatten)
    from repro_torch.models.transformer import moe as moe_mod
    from repro_torch.models.transformer import moe_sharded as sharded_mod
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train.data import lm_batches
    from repro_torch.train.loop import init_state, lm_loss, make_train_step
    from repro_torch.train.optim import OPTIMIZERS, cosine_schedule

    cfg = _no_drop(_mesh_config(run, run["module"], run["train_layers"]))
    cfg = cfg.scaled(moe_impl="shard_map", dtype="float32",
                     param_dtype="float32",
                     moe=dataclasses.replace(cfg.moe, router_aux_weight=0.0))
    sched = cosine_schedule(**TRAIN_SHARDED_SCHEDULE)
    t_run = time.perf_counter()

    def whole_state():
        model = Transformer(cfg, seed=22, device=dev)
        return model, init_state(seed_key(22), model.params, cfg.optimizer)

    def stepper(loss_fn, box, **kw):
        """``make_train_step`` whose update keeps its first gradients."""
        saved = OPTIMIZERS[cfg.optimizer]
        OPTIMIZERS[cfg.optimizer] = _capturing(cfg.optimizer, box)
        try:
            return make_train_step(loss_fn, optimizer=cfg.optimizer,
                                   lr_schedule=sched, **kw)
        finally:
            OPTIMIZERS[cfg.optimizer] = saved
    _reset_peak(dev)
    model, state = whole_state()
    lays = lm_state_shardings(state, mesh, moe_impl=cfg.moe_impl)
    shards = shard_tree(state, lays)
    del model, state
    _reset_peak(dev)
    seen = []
    step = stepper(lm_loss(Transformer(cfg, device="meta"),
                           lm_constrain(cfg, mesh)), seen,
                   state_shardings=lays)
    data = lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=22, device=dev)
    batches = [next(data) for _ in range(TRAIN_SHARDED_STEPS)]
    rows = lm_batch_shardings(mesh, kind="train")
    res = {"rank": rank, "coords": list(mesh.coords), "step_ms": [],
           "losses": []}
    route, k, n_layers = sharded_mod.route, cfg.moe.top_k, cfg.n_layers
    chosen = []

    def recording(params, x, moe, capacity=None):
        r = route(params, x, moe, capacity)
        if len(chosen) < n_layers:   # the first forward, layer by layer
            chosen.append(torch.topk(r["probs"].detach(), k).indices)
        return r

    def whole(tree):
        """The whole tree from every rank's shards, on rank 0's host."""
        out = [lay.gather(x).to("cpu", copy=True) for lay, x in
               zip(tree_leaves(lays.params), tree_leaves(tree))]
        return tree_unflatten(tree, out) if rank == 0 else None
    for i, b in enumerate(batches):
        sharded_mod.route = recording if i == 0 else route
        try:
            (shards, m), ms = _clock(dev, lambda: step(
                shards, {key: rows.shard(v) for key, v in b.items()}))
        finally:
            sharded_mod.route = route
        res["step_ms"].append(ms)
        res["losses"].append(float(m["loss"]))
        if i == 0:
            got_params, got_grads = whole(shards.params), whole(seen.pop())
    p_lays, p_shards = tree_leaves(lays.params), tree_leaves(shards.params)
    gather = reduce = 0
    for lay, s in zip(p_lays, p_shards):
        comp = 1
        for dim in range(s.ndim):
            comp *= s.shape[dim] * (lay.parts(dim)
                                    if dim in lay._gathered_dims(s.ndim)
                                    else 1)
        gather += (comp - s.numel()) * s.element_size()
        reduce += comp * s.element_size() * len(lay.compute_replicas())
    res["gather_bytes_per_step"] = gather
    res["reduce_bytes_per_step"] = reduce
    res["shard_bytes"] = sum(s.numel() * s.element_size()
                             for s in tree_leaves(shards)
                             if isinstance(s, torch.Tensor))
    res["peak_memory_gb"] = _peak_gb(dev)
    del shards, step
    # every rank's block of each layer's routing, in token order (rank r
    # holds token block r)
    routed = []
    for e in chosen:
        parts = [torch.empty_like(e) for _ in range(mesh.size)]
        dist.all_gather(parts, e.contiguous())
        routed.append(torch.cat(parts))
    _reset_peak(dev)                  # rank 0's single step needs the room
    if mesh.size > 1:
        dist.barrier()
    if rank == 0:
        model, state = whole_state()
        stacked = state.params["layers"]["mlp"]["router"]
        own_route = moe_mod.route
        ties = {"tokens_routed_otherwise": {}, "largest_tie_margin": 0.0}

        def replaying(params, x, moe, capacity=None):
            layer = next(i for i in range(n_layers)
                         if torch.equal(params["router"], stacked[i]))
            r = own_route(params, x, moe, capacity)
            want = routed[layer]
            probs = r["probs"].detach()
            differ = (torch.topk(probs, k).indices != want).any(dim=1)
            ties["tokens_routed_otherwise"][layer] = int(differ.sum())
            if bool(differ.any()):
                margin = float(_top_margin(probs, k)[differ].max())
                if margin >= ROUTING_TIE:
                    raise AssertionError(
                        f"layer {layer}: the single-process step routes "
                        f"{int(differ.sum())} tokens otherwise, at a top-k "
                        f"margin of up to {margin}")
                ties["largest_tie_margin"] = max(
                    ties["largest_tie_margin"], margin)
            return _routing(r["probs"], want, r["c"])
        single_grads = []
        single = stepper(lm_loss(model), single_grads)
        moe_mod.route = replaying
        try:
            single(state, batches[0])
        finally:
            moe_mod.route = own_route
        res["routing_ties"] = ties
        del model, state
        names = []
        tree_map_with_path(lambda p, _: names.append(p), got_grads)
        res["grad_max_abs_err"] = {
            name: _rel_hold(f"train_sharded gradient {name}", g, w,
                            TRAIN_SHARDED_GRAD_TOL)
            for name, g, w in zip(names, tree_leaves(single_grads.pop()),
                                  tree_leaves(got_grads))}
        _reset_peak(dev)
        _, state = whole_state()
        _, update = OPTIMIZERS[cfg.optimizer]
        want, _ = update(tree_map(lambda g: g.to(dev), got_grads),
                         state.opt_state, state.params, lr=sched(0))
        del state
        res["hold_max_abs_err"] = _leaf_err(
            "train_sharded params after a step (the single-process update "
            "by the sharded gradients vs 2x2)", want, got_params,
            TRAIN_STEP_TOL)
    del got_params, got_grads
    if mesh.size > 1:
        dist.barrier()
    res["wall_s"] = time.perf_counter() - t_run
    return res


def bitwise_run(mesh, dev, run):
    """``make_train_step(state_shardings=)`` on a mesh of one rank against
    the unsharded step: ``run["bitwise_module"]`` whole, its AdamW,
    ``TRAIN_SHARDED_STEPS`` steps from one state under deterministic
    algorithms; every leaf equal bit for bit."""
    import torch
    from repro_torch.core._threefry import seed_key
    from repro_torch.launch.sharding import lm_state_shardings
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer.model import Transformer
    from repro_torch.train.data import lm_batches
    from repro_torch.train.loop import init_state, lm_loss, make_train_step
    from repro_torch.train.optim import cosine_schedule

    cfg = _mesh_config(run, run["bitwise_module"])
    _reset_peak(dev)
    model = Transformer(cfg, seed=22, device=dev)
    start = init_state(seed_key(22), model.params, cfg.optimizer)
    data = lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=22, device=dev)
    batches = [next(data) for _ in range(TRAIN_SHARDED_STEPS)]
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "optimizer": cfg.optimizer}
    states = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, lays in (("unsharded", None), ("sharded_1x1",
                           lm_state_shardings(start, mesh))):
            step = make_train_step(
                lm_loss(model), optimizer=cfg.optimizer, donate=False,
                lr_schedule=cosine_schedule(**TRAIN_SHARDED_SCHEDULE),
                state_shardings=lays)
            s = tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor)
                         else v, start)
            res[f"{name}_step_ms"] = []
            for b in batches:
                (s, _), ms = _clock(dev, lambda: step(s, b))
                res[f"{name}_step_ms"].append(ms)
            states[name] = s
    finally:
        torch.use_deterministic_algorithms(False)
    res["bitwise"] = _same_state(states["sharded_1x1"], states["unsharded"])
    if not res["bitwise"]["equal"]:
        raise AssertionError(f"the sharded step on mesh (1, 1) is not the "
                             f"unsharded one: {res['bitwise']}")
    res["peak_memory_gb"] = _peak_gb(dev)
    return res


def _gloo_probe(dev, world, rank):
    """None if gloo carries every collective the mesh phases use on
    ``dev`` tensors (bfloat16 and float32), else the refusal."""
    import torch
    import torch.distributed as dist
    try:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.arange(2 * world, device=dev).to(dt)
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            want = torch.tensor([2 * rank, 2 * rank + 1] * world).to(dt)
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            s = torch.ones(3, device=dev, dtype=dt)
            dist.all_reduce(s)
            if not torch.equal(y.cpu(), want) or \
                    not all(torch.equal(p, x) for p in parts) or \
                    not bool((s == world).all()):
                return f"gloo gave wrong {dt} results on {dev} tensors"
    except (RuntimeError, ValueError) as err:   # the refusal is the result
        return f"{type(err).__name__}: {err}"
    return None


def _mesh_rank(rank, world, store_path, out_dir, device, run):
    """One gloo rank of the 4-rank world on the one card: the probe, the
    sharded MoE on each of ``MOE_LAYOUTS``, the sharded train step on
    (2, 2)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat
    import os
    # four processes share the card: no allocator segment left stranded
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        err = _gloo_probe(dev, world, rank)
        ok = torch.tensor([0 if err else 1])
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        result = {"rank": rank}
        if int(ok) == 0:
            result["refused"] = err or "another rank's probe failed"
        else:
            try:
                result["moe"] = {
                    f"{a}x{b}": moe_sharded_run(make_mesh_compat(
                        (a, b), ("data", "model"), device=device), dev, run,
                        rank) for a, b in MOE_LAYOUTS}
                result["train"] = train_sharded_run(make_mesh_compat(
                    (2, 2), ("data", "model"), device=device), dev, run,
                    rank)
            except Exception:           # every rank's traceback is kept
                import traceback
                result["error"] = traceback.format_exc()
                raise
            finally:
                (Path(out_dir) / f"mesh_rank{rank}.json").write_text(
                    json.dumps(result))
            return
        (Path(out_dir) / f"mesh_rank{rank}.json").write_text(
            json.dumps(result))
    finally:
        dist.destroy_process_group()


def mesh_phases(dev, card):
    """The ``moe_sharded`` and ``train_sharded`` phases: the sharded MoE
    (``models.transformer.moe_sharded``) and the sharded train state
    (``make_train_step(state_shardings=)``, ``launch.sharding``) in a
    world of one (NCCL on the card) in this process, then over 4 gloo
    ranks sharing the card; the dry run (``launch.dryrun --all``) on the
    host beside them."""
    import os

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from repro_torch.launch.mesh import make_mesh_compat
    from torch.multiprocessing.spawn import ProcessException

    t_phase = time.perf_counter()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mesh_", dir=build_dir))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(work / "dryrun")], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{work}/one",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=MESH_TIMEOUT_S))
        try:
            mesh = make_mesh_compat((1, 1), ("data", "model"),
                                    device=str(dev))
            moe1 = moe_sharded_run(mesh, dev, MESH_RUN, 0)
            t_moe1 = time.perf_counter() - t_phase
            bit1 = bitwise_run(mesh, dev, MESH_RUN)
        finally:
            dist.destroy_process_group()
        t_world1 = time.perf_counter() - t_phase
        emit("moe_sharded_world1", backend=backend, layout=[1, 1],
             card=card, **moe1)
        emit("train_sharded_world1", backend=backend, layout=[1, 1],
             card=card, **bit1)
        _reset_peak(dev)              # the 4 ranks share the card

        t = time.perf_counter()
        ctx = tmp.spawn(_mesh_rank, nprocs=MESH_RANKS, join=False,
                        args=(MESH_RANKS, str(work / "gloo"), str(work),
                              str(dev), MESH_RUN))
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t > MESH_TIMEOUT_S:
                    raise AssertionError(f"the {MESH_RANKS}-rank world ran "
                                         f"past {MESH_TIMEOUT_S} s")
        except ProcessException as e:
            errors = [json.loads(f.read_text()).get("error")
                      for f in sorted(work.glob("mesh_rank*.json"))]
            raise AssertionError(f"a rank failed: {e}; the ranks' errors: "
                                 f"{[x for x in errors if x]}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        ranks = [json.loads((work / f"mesh_rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
        wall4 = time.perf_counter() - t
        refused = [r["refused"] for r in ranks if "refused" in r]
        if refused:
            emit("mesh_4rank_refused", backend="gloo", ranks=MESH_RANKS,
                 error=refused[0], card=card)
            raise AssertionError(f"gloo refused a collective on the card: "
                                 f"{refused[0]}")
        for name in ranks[0]["moe"]:
            per = [r["moe"][name] for r in ranks]
            emit("moe_sharded_4rank", backend="gloo", layout=name,
                 card=card, aux=per[0]["aux"],
                 tokens_per_rank=per[0]["tokens_per_rank"],
                 experts_per_rank=per[0]["experts_per_rank"],
                 capacity_per_rank=per[0]["capacity_per_rank"],
                 a2a_bytes_per_rank=per[0]["a2a_bytes_per_rank"],
                 a2a_per_fwd_bwd=per[0]["a2a_per_fwd_bwd"],
                 **{key: [p[key] for p in per] for key in (
                     "fwd_ms", "fwd_bwd_ms", "a2a_ms", "peak_memory_gb",
                     "holds_max_abs_err", "wall_s")})
        emit("moe_sharded", card=card, config=MESH_RUN["module"],
             tokens=MESH_RUN["moe_tokens"], layouts=["1x1"]
             + list(ranks[0]["moe"]), holds_passed=True,
             world1_wall_s=t_moe1)
        per = [r["train"] for r in ranks]
        emit("train_sharded_4rank", backend="gloo", layout=[2, 2],
             card=card, layers=MESH_RUN["train_layers"],
             batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             schedule=TRAIN_SHARDED_SCHEDULE,
             hold_max_abs_err=per[0]["hold_max_abs_err"],
             param_dtype="float32",
             hold_tolerance=dict(gradients=TRAIN_SHARDED_GRAD_TOL,
                                 params=TRAIN_STEP_TOL),
             grad_max_abs_err=per[0]["grad_max_abs_err"],
             routing_ties=per[0]["routing_ties"],
             **{key: [p[key] for p in per] for key in (
                 "step_ms", "losses", "gather_bytes_per_step",
                 "reduce_bytes_per_step", "shard_bytes",
                 "peak_memory_gb", "wall_s")})
        out, err = dry.communicate(timeout=MESH_TIMEOUT_S)
        if dry.returncode != 0:
            raise AssertionError(f"the dry run failed: {err[-2000:]}")
        peaks = {}
        for f in sorted((work / "dryrun").glob("*.json")):
            rec = json.loads(f.read_text())
            if rec["status"] == "ok":
                mem = rec["memory"]["peak_bytes_per_device"]
                best = peaks.get(rec["mesh"])
                if best is None or mem > best[0]:
                    peaks[rec["mesh"]] = (mem, f"{rec['arch']} x "
                                          f"{rec['shape']}")
        emit("dryrun", summary=out.strip().splitlines()[-1],
             largest_peak_bytes_per_device={
                 m: {"bytes": b, "cell": c} for m, (b, c) in peaks.items()},
             device_bytes=80 * 2 ** 30)
        emit("train_sharded", card=card, world1_wall_s=t_world1,
             world4_wall_s=wall4,
             both_phases_wall_s=time.perf_counter() - t_phase)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait(10)
        shutil.rmtree(work, ignore_errors=True)


def _launch_args(tmp):
    return ("-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
            "--smoke", "--steps", "4", "--ckpt-dir", f"{tmp}/launch",
            "--ckpt-every", "2")


def _device_profile(run):
    """``run()`` under ``torch.profiler`` (CPU and CUDA activity), ended by
    a synchronize: (t_start, t_end, {kernel: (device us, calls)})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
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
    return t, t_end, per_kernel


def _busy(wall_ms, per_kernel, top_n=10):
    """The device-time fields of a profiled window's line."""
    device_ms = sum(us for us, _ in per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    return dict(
        device_ms=device_ms if per_kernel else "not measured",
        device_busy_share=device_ms / wall_ms if per_kernel
        else "not measured",
        top_kernels=[{"name": k[:80], "device_ms": us / 1e3, "calls": c}
                     for k, (us, c) in top])


def profile_round(srv, rng, n, card, phase="profile", insert=True):
    """One more served round (20 000 queries, then 100 inserts unless
    ``insert`` is False) through ``srv`` (a server or an engine) under
    ``torch.profiler``: device time by kernel and the device's busy share
    of the round's wall time.  Runs after the launch counts were read."""
    u = rng.integers(0, n, QUERIES).astype(np.int32)
    v = rng.integers(0, n, QUERIES).astype(np.int32)
    ns = rng.integers(0, n, INSERTS).astype(np.int32)
    nd = rng.integers(0, n, INSERTS).astype(np.int32)
    marks = {}

    def run():
        srv.query(u, v)
        marks["tq"] = time.perf_counter()
        if insert:
            srv.insert(ns, nd)
    t, t_end, per_kernel = _device_profile(run)
    wall_ms = (t_end - t) * 1e3
    emit(phase, card=card, wall_ms=wall_ms,
         query_wall_ms=(marks["tq"] - t) * 1e3,
         insert_wall_ms=(t_end - marks["tq"]) * 1e3,
         **_busy(wall_ms, per_kernel))


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
    _build.build(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        _build.load(name)
    emit("build", seconds=time.perf_counter() - t,
         libs=[str(_build.library_path(n).relative_to(ROOT))
               for n in _build.SIGNATURES])
    emit("ptxas", **{name: ptxas_summary(_build.ptxas_report(name))
                     for name in _build.SIGNATURES})

    worst, cases = parity_sweep(dev)
    emit("parity", cases=cases, max_abs_err=worst, bitwise=True)
    timings = kernel_timings(dev)
    emit("kernel_times", card=card, **timings)
    timings.update(relax_timings(dev, card))
    emit("relax_times", card=card, **{k: v for k, v in timings.items()
                                      if k.startswith("relax_kernel.")})

    launches = main_path(dev, card)
    launches.update(dynamic_phase(dev, card))
    for name, c in il_packed_phase(dev, card).items():
        launches[name] += c
    for name, c in sharded_phase(card).items():
        launches[name] += c
    for name, c in baselines_phase(dev, card).items():
        launches[name] += c
    for name, c in aot_phase(dev, card).items():
        launches[name] += c
    for name, c in warmup_phase(dev, card).items():
        launches[name] += c
    for name, c in gnn_phase(dev, card).items():
        launches[name] += c
    mind_phase(dev, card)
    lm_phase(dev, card)
    train_phase(dev, card)
    mesh_phases(dev, card)

    csrc = "src/repro_torch/kernels/csrc"
    meta = {
        "verdicts_kernel": (f"{csrc}/dbl_query.cu",
                            "src/repro/kernels/dbl_query/dbl_query.py:94"),
        "admit_kernel": (f"{csrc}/bfs_prune.cu",
                         "src/repro/kernels/bfs_prune/bfs_prune.py:77"),
        "streamed_verdicts_kernel": (
            f"{csrc}/dbl_query_streamed.cu",
            "src/repro/kernels/dbl_query/dbl_query.py:272"),
        "streamed_admit_kernel": (
            f"{csrc}/bfs_prune_streamed.cu",
            "src/repro/kernels/bfs_prune/bfs_prune.py:228"),
        # replaces no TPU kernel (XLA packed there); held bitwise at its
        # main-path shape by ``timed``
        "pack_planes_kernel": (f"{csrc}/pack_planes.cu", None),
        # replaces no TPU kernel (XLA relaxed there); held bitwise on every
        # round of ``relax_timings``
        "relax_kernel": (f"{csrc}/bfs_relax.cu", None),
    }
    # the pack's and the relax's launches from main_path's reset on: every
    # later phase of this process (each build and insert, each BFS round)
    # adds to them; a relax step is the row pass and relax_kernel
    from repro_torch.kernels.bfs_relax.bfs_relax import bfs_relax
    from repro_torch.kernels.pack_planes.pack_planes import pack_label_planes
    launches["pack_planes_kernel"] = pack_label_planes.launches
    launches["relax_kernel"] = bfs_relax.launches
    worst["pack_planes_kernel"] = timings["pack_planes_kernel"]["max_abs_err"]
    worst["relax_kernel"] = timings["relax_kernel"]["max_abs_err"]
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"], "host_loop_ms": t["host_loop_ms"],
            **({"launch_floor_ms": t["launch_floor_ms"]}
               if "launch_floor_ms" in t else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
