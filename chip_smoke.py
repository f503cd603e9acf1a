#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their plain versions.

Run from the repository root, on a machine with one CUDA card and ``nvcc``:

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --breakdown    # phases 1-3 and K2's and K3's stage breakdowns only
    python3 chip_smoke.py --times        # phases 1, 3 and K1's / K2's / K3's device times only
    python3 chip_smoke.py --bulk         # phases 1, 3 and bulk passes at inflight 3, 1, 1, 3 only
    python3 chip_smoke.py --serving      # phases 1-3, 12 and the serving phase (17) only
    python3 chip_smoke.py --frontdoor    # phases 1-3 and the front-door phase (18) only
    python3 chip_smoke.py --cluster      # phases 1-3 and the cluster phase (19) only
    python3 chip_smoke.py --mesh         # phases 1-3 and the mesh phase (20) only
    python3 chip_smoke.py --compile      # phases 1-3 and the compile-watch phase (21) only
    python3 chip_smoke.py --procmesh     # phases 1-3, the mesh (20) and the process mesh (22) only
    python3 chip_smoke.py --probes       # phase 1, the probes' build and phases 15-16 only

Phases, each of which must pass (nothing is caught and skipped).  The
full run and ``--compile`` take them in the order 1, 3, 21, 2, 4-20, 22,
23, 24: phase 21 needs a process in which no kernel library is loaded yet.

1. print the card's name, the device count and ``nvidia-smi``'s name and
   power limit;
2. build the kernels from ``distributed_sudoku_solver_tpu_torch/csrc``
   (one ``nvcc`` per library, started together: K1, K2, K3, the fused
   loop's bookkeeping kernel, the two probe kernels P16 and PCV, and K2's
   and K3's counter builds; in the full run and under ``--compile`` phase
   21 has built them: its nodes K1's, K2's and the bookkeeping's libraries
   at first use, the smoke the other five) and print, per
   kernel instantiation (K1 and K2 are templates on the box shape, K3 on
   the instance's row and covered words, P16 on the mask bits, PCV on the
   row words), ptxas's registers, spills and stack frame and the warps an
   SM holds at that register count; fails if any instantiation spills;
3. generate the corpus: 65,533 seeded 24-clue 9x9 boards carved with
   ``make_puzzle(unique=False)`` plus ``HARD_9`` (every carved board keeps
   its parent solution, so no board may come back unsat);
4. K1 (fixpoint) against its plain version: 32,768 boards on every rule
   tier, plus 6x6, 12x12 (3x4 boxes, the run-time instantiation), 16x16
   and 25x25 batches; masks and sweep counts bit-equal;
5. K2 (fused rounds) against its plain version: one dispatch of a
   32,768-lane frontier seeded from the corpus (S=12, k_steps=8, extended
   rules) for every legacy branch rule, count_mode off and on; all 13
   outputs bit-equal (``sweeps_total`` under the port's per-lane sum);
   timed with minrem at that shape and on an 8,192-lane 16x16 frontier;
   then K2's counter build at the 9x9 shape with minrem and ``head:mlp``:
   each stage's share of the warps' ``clock64()`` cycles (the breakdown);
6. the main path, ``solve_bulk(corpus, SUDOKU_9, BulkConfig())`` twice
   (``inflight=3``): every solution valid and agreeing with its givens, no
   board unsat, K2's launch count above zero and the fused loop's
   bookkeeping kernel run once a K2 dispatch (its graph's replays counted,
   from zero before the second pass); boards/s of the second pass
   and its pack / solve / drain trace; then passes with ``inflight`` 1, 3
   and 1, each result identical to the second pass's, with boards/s and
   trace; then one more pass under torch.profiler for device time by
   kernel;
7. the composite path, ``solve_batch`` on 4,096 corpus boards with
   ``SolverConfig(propagator="pallas")``: verdicts checked, K1's launch
   count above zero;
8. K3 (cover rounds) against its plain version: a 4,096-lane, S=128
   frontier of ``nqueens_cover(14)``, ``pentomino_cover(6, 10)`` and
   ``sudoku_cover(SUDOKU_9)`` (HARD_9 clue roots), fanned out by driver
   rounds; one dispatch (k_steps=8) with count_mode off and on, all 13
   outputs bit-equal; the kernel's device time (torch.profiler), the
   wrapper's CUDA-event time, plain time and bound of each; then K3's
   counter build on each frontier: each stage's share of the warps'
   ``clock64()`` cycles, and the longest warp's cycles against the mean;
9. the cover path at full width, ``solve_csp`` with ``step_impl="fused"``,
   4,096 lanes, S=128, ``count_all``, ``steal_rounds=4``: n-queens 14 must
   count 365,596 and pentomino 6x10 9,356, exhausted, no overflow, K3's
   launch count above zero and the bookkeeping kernel run once a K3
   dispatch; wall, solutions/s and dispatches of the second run of each;
   then n-queens 14 once more under torch.profiler; then the fused loop's
   bookkeeping kernel (``csrc/bookkeep.cu``) against its plain version
   (``ops/cuda_bookkeep.bookkeep_plain``) on one real dispatch at each
   benchmark cell's shape: pentomino 6x10 at 32,768 lanes, one job,
   S=128, count mode, fanned out by 160 steps of fused dispatches, and
   32,768 16x16 boards, one job a lane, S=12, k=8, after two dispatches;
   every field, the next top, the flag and the gated ``has_top`` bit-equal;
   both again with the flag false at entry (a spare dispatch of the
   look-ahead), each leaving every buffer as it was; the kernel's device
   time (torch.profiler, its three launches a call), the plain version's
   and the bound by the bytes it has to move;
10. the composite cover path (``step_impl="xla"``): n-queens 12 must count
   14,200, and each HARD_9 board solved through ``sudoku_cover`` must
   decode to the native oracle's solution;
11. K2 with each scored branch head (``head:minrem``, ``head:cw-slack``,
   ``head:mlp``) against its plain version at phase 5's shape (count_mode
   off), all 13 outputs bit-equal; the kernel's device time
   (torch.profiler), the plain version's time and the bound of each;
12. the head path at full width: ``solve_batch(step_impl="fused")`` on
   32,768 corpus boards (HARD_9 among them) at 32,768 lanes with
   ``minrem`` and each head: ``head:minrem``'s nodes and steps equal
   ``minrem``'s, every rule solves every board with valid, clue-keeping
   solutions (HARD_9 equal to the oracle's), K2 launched; boards/s and
   nodes per rule;
13. the latency flight as the serving megastep drives it: a one-slot,
   8-lane mailbox (``steal_gang=8``, no step budget, fused,
   ``head:cw-slack``) seeded from padding roots; per board (each HARD_9
   and the corpus's two boards with the most nodes): ``attach_roots`` ->
   ``advance_megastep_fused`` (64-round chunks, at most 64) -> the status
   word and verdict payload in one transfer -> ``detach``; each verdict
   equal to ``solve_one``'s; flight wall, chunks and host syncs (counted
   with ``torch.cuda.set_sync_debug_mode``);
14. snapshot resume: ``solve_batch_checkpointed`` on 4,096 boards,
   interrupted after its first chunk, resumed from the snapshot on disk,
   bit-identical to an uninterrupted run on every field;
15. P16, the uint16 probe's fixpoint kernel, against its plain version on
   the probe's 65,536 boards (the JAX probe's corpus: 512 unique 24-clue
   boards, ``puzzle_batch(SUDOKU_9, 512, seed=7, n_clues=24)``, tiled;
   both mask widths; caps 64, 1 and 2; an odd board count); then the
   probe's own run, ``probes.uint16.run_probe`` (16 chained dispatches per
   width, best of 3 interleaved), with its launches counted from zero:
   ``uint32_fixpoints_per_s``, ``uint16_fixpoints_per_s``,
   ``speedup_uint16``, ``bit_equal_low16``; the input's per-warp
   divergence (the warp's largest sweep count over the mean, at 32 and 64
   boards a warp) beside the kernel queue's model of it; each width's
   device time (the profiler, and CUDA events around 20 launches back to
   back), plain time and bound;
16. PCV, the cover-primitive probe's kernel, against its plain version on
   the probe's seed-0 inputs at 3, 0, 1 and 7 steps; then the probe's own
   run, ``probes.cover_kernel.run_probe`` (which fails unless the output
   words reproduce the pinned checksum 653,337,268); device time with the
   L2 cache warm and flushed before each launch, plain time and bound; and
   the device time of an empty launch (a one-word fill), the floor under
   PCV's bound, read the same two ways.  ``--probes`` runs phases 1, 15
   and 16 alone after building just the two probe libraries, then prints
   each probe kernel's SASS instruction counts (``cuobjdump``; P16's sweep
   loop by opcode); like ``--times`` it measures the checkout that holds
   the script, so a copy in a parent's ``git archive`` times the parent's
   kernels (parent, change, change, parent in one call);
17. the serving stack over HTTP, at the CLI's default 9x9 deployment
   (``max_batch=256``, ``chunk_steps=64``, S=64, basic rules, minrem,
   ``ResidentConfig()``, ``MegastepConfig()``), ``host_fetch`` counted by
   tag.  Node F (``SolverConfig(step_impl="fused")``, K2): 1,024
   ``POST /solve`` from 32 client threads (corpus boards, HARD_9 and 16
   carved 16x16 boards; clients honour 429 and Retry-After), a burst of
   the 200 hardest corpus boards at once without retries (must draw a 429
   with Retry-After), 8 ``POST /solve?latency=1`` (HARD_9 and the five
   hardest), a ``count_all`` on an 8-solution board (equal to the
   oracle's count), ``POST /solve_batch`` of 4,096 boards as lines, then
   ``GET /stats``, ``/metrics``, ``/metrics?format=prometheus`` (promck
   clean), ``/status`` and ``/trace/<uuid>?analyze=1``; K2's launches
   counted from zero, one ``status`` fetch per chunk and per megastep
   flight, every fallback counter 0.  Node C
   (``SolverConfig(propagator="pallas")``, no resident flight, K1): 256
   concurrent ``POST /solve``; K1's launches counted from zero, one
   ``status`` fetch per chunk; its flights replayed by hand on an engine
   with ``SolverConfig()`` must give bit-identical solutions and node
   counts.  Every 201 valid and keeping its givens, no satisfiable board
   422, each verdict equal to ``solve_batch``'s on the same config.
   Printed: requests, requests/s and p50 / p95 / p99 ms per route, the
   engines' chunk counts and walls, host syncs per chunk per route (torch's
   sync debug mode, one route at a time);
18. the front door and the portfolio over HTTP.  Node D is node F plus
   ``FrontDoorConfig()``; the native oracle must have built (its build
   seconds printed).  Pass A: 1,024 unique 9x9 boards carved with
   ``make_puzzle(unique=True)`` (seeds 1000.., clue targets 22-30) and
   HARD_9 from 32 clients honouring 429 and Retry-After, each 201 equal to
   the native oracle's unique solution; pass B: each board under one
   seeded ``random_transform``, each answer the transformed solution, the
   cache answering at least every cacheable pass-A verdict; 8 boards made
   unsat by a conflicting given answer 422, and their transforms 422 from
   the negative cache; 16 carved 16x16 boards answered validly and
   counted uncacheable; 8 ``"portfolio": true`` requests (HARD_9 and the
   five pass-A boards of highest probe score), each the oracle's solution;
   every route (cache, propagation, native, device) used, K2 launched
   (counted from zero), every fallback counter 0, Prometheus promck-clean.
   Then ``race_cover(nqueens_cover(12))`` on the card must count 14,200,
   complete; ``solve_file`` on phase 3's boards written as lines, every
   output line valid and keeping its givens, none unsat, K2 launched; and
   ``StandaloneNode()`` must build a front door on CUDA and answer two
   boards.  Printed: requests/s per pass, per route the count and the
   ``frontdoor_*_ms`` histograms' p50 / p95 / p99, the portfolio walls and
   winners, the cover race's winner and wall, ``solve_file``'s boards/s;
19. the cluster and the CLI at the CLI's default deployment.  Ring R:
   three node processes started as a user starts them, ``python -m
   distributed_sudoku_solver_tpu_torch -p <http> -s <p2p> --host 127.0.0.1
   --advertise-host 127.0.0.1`` (B and C with ``-a`` A's p2p address),
   after phase 2 built the kernels, until every ``GET /network`` lists 3
   members.  Pass A: 1,024 unique boards (phase 18's: seeds 1000.., clue
   targets 22-30) plus HARD_9 from 32 clients round-robin over A, B and
   C, each 201 the native oracle's solution, and every node's engine
   running TASKs that another node accepted (``tasks_run``).  Pass B: each
   board under one seeded transform, sent to the next node, bit-exact in
   the client's frame, the digest owners' caches answering at least every
   cacheable board (cache-affine routing sends a repeat to the owner of
   its orbit); the DHT shards and gossip views printed.  Crash: 256 fresh
   unique boards (seeds 5000..) from 32 clients to A and B; C is
   SIGKILLed once it runs a job of theirs; A and B must list 2 members
   within fail_factor x heartbeat_s + 5 s, every request must be answered
   with the oracle's solution (none lost, no 5xx), at least one job must
   have been re-executed; C restarts on its ports and all three list 3
   members again.  ``POST /solve_batch`` of 4,096 boards (K2) on each
   node, checked; ``/metrics?scope=cluster``'s rollup ``jobs_done`` the
   sum of the nodes' and no node unreachable; SIGTERM to each node, which
   prints its ``drain:`` line and exits 0.  In this process: (F)
   ``cli.main(["solve-file", ...])`` on phase 3's boards as lines, every
   line solved and valid, K2 launched; (O) two ``ClusterNode``s over TCP
   whose engines are node F's without a resident flight and with 8-round
   chunks (the proof below runs 98 rounds: at node F's 64 it spans two
   chunks, which leaves a NEEDWORK almost no boundary to shed at): the
   deep unsat board (HARD_9[1] with one wrong clue) on the first, slowed
   by a 0.05 s handicap per sync, until the second has asked for work and
   run a shed SUBTASK (at most 32 boards), every verdict unsat as the
   oracle's, K2 launched.  Printed: requests/s and p50 / p95 / p99 per
   pass, the detection and rejoin walls, re-executions, resumes, SUBTASK
   counts, the DHT counters, ``solve-file``'s boards/s;
20. the mesh: four shards on the one card (``parallel.virtual_devices(4)``;
   every shard launches its own kernels on its own lane block, and every
   round runs the collectives between the shards; cross-card copies are
   not measured).  (a) ``solve_batch_sharded`` on 4,096 corpus boards with
   ``SolverConfig()``: solved and unsat bit-equal to ``solve_batch``'s,
   every solution valid and bit-equal wherever the board has one solution
   (the native oracle counts them); HARD_9[0] among 63 copies of EASY_9
   must be solved through the ring steal (steals and ring rows above 0);
   the 4,096 boards again with ``propagator="pallas"``: K1 launched on
   every shard every round, verdicts equal.  (b) ``solve_batch_fused_
   sharded`` on 32,768 corpus boards at phase 5's shape (S=12, extended,
   minrem) against the single-device fused solve, as in (a); K2 launched at
   least 4 times per round, ring rows above 0; wall, boards/s, rounds and
   host syncs per round.  (c) the same on 1,024 boards through K2 and
   with the plain rounds on the card: every field equal.  (d)
   ``solve_csp_fused_sharded`` at phase 9's width: n-queens 14 must count
   365,596 and pentomino 6x10 9,356, K3 launched; walls beside phase 9's.
   (e) ``solve_bulk(corpus, SUDOKU_9, BulkConfig(), mesh=mesh)``: every
   solution valid with its givens, none unsat; boards/s beside phase 6's.
   (f) an engine with ``ResidentConfig(job_slots=16, gang_lanes=8,
   mesh_devices=4)`` serves 256 corpus boards and HARD_9 on a
   ``MeshResidentFlight``: solutions equal a single-device engine's (64
   slots), ``mesh_unfit`` 0, ring rows shipped, one ``status`` fetch per
   chunk; outside the virtual devices the same config on the one card
   counts ``mesh_unfit`` and serves.  (g) ``solve_batch_banded`` on the
   four shards, HARD_9 and one 25x25 board, every field bit-exact against
   ``solve_batch``.  (h) ``cli.main([..., "--sharded"])`` in process
   answers ``POST /solve`` through ``solve_batch_sharded`` over
   ``default_mesh()`` (one card);
21. the compile watch, the cost plane and the analysis runner.  (a) Node F
   booted through ``cli.main`` (``--no-frontdoor --trace --compile-warmup
   600 --compile-rearm 5 --peak-gflops`` the int32 peak above, in G ops/s;
   the CLI's engine with ``step_impl="fused"``, which the CLI has no flag
   for) installs its compile watch and builds nothing at boot.  Its first
   request, alone on the host, builds and loads K2's library and the
   fused loop's bookkeeping kernel's through ``cuda_build.load`` under the
   watch; the wall from the node's start to that answer is the time to a
   serving node.  An in-process node C (composite, K1) does the same for
   K1's library with its first static request; ``/metrics`` ``compile``
   must then show exactly those three libraries, each built once and
   loaded once, with the nvcc seconds.
   The smoke then builds the five libraries no node has used (one nvcc
   each, all at once, in a process of its own, so no watch hears of it)
   beside phase 17's routes: 512 corpus boards and HARD_9 resident,
   HARD_9 ``?latency=1``, a ``count_all``, ``/solve_batch`` of 1,024, and
   on node C 128 static boards and 16 16x16 boards, after which the watch
   must still show only the two libraries.  (b) The warmup is sealed;
   a second pass (256 resident, 32 static) makes no recompile, and the
   host syncs per resident chunk and per megastep flight (8 boards and
   HARD_9, one request at a time) are equal with the watch on and off, in
   turns on, off, off, on, after an uncompared warm-up turn.  (c) K3's
   first load (a fused n-queens 12 enumeration, 14,200) is exactly one
   recompile, one ``[compile cover]``
   line and one flight-recorder dump; after 5 s of quiet the alarm
   re-arms, and the cover probe's first load fires a second dump.  (d)
   ``/metrics`` ``cost``, read while the fused advance has one shape: K2's
   per-round int32 ops at 128 lanes equal ``ops.cost.advance_round_cost``,
   an achieved rate, a device efficiency in (0, 1.05]; after the
   ``count_all`` flight the gauge reads ``suppressed: mixed_shapes``;
   ``/metrics?format=prometheus`` promck-clean and ``/trace?format=
   perfetto`` traceck-clean.  (e) ``python -m
   distributed_sudoku_solver_tpu_torch.analysis --strict-waivers`` exits 0
   without importing torch, and ``--rule kernelck`` exits 0;
22. the process mesh: two worker processes (this script with
   ``--procmesh-worker``) join one ``torch.distributed`` gloo group through
   a file store in a temporary directory (gloo timeout 120 s), and each
   builds ``make_process_mesh(2, device="cuda")`` inside
   ``virtual_devices(2)``: four shards, two per process, all on the one
   card, every cross-process operand staged through host memory.  Each
   worker runs phase 20's (a) with ``propagator="pallas"`` (K1), (b) (K2),
   (d) (K3), (e) and (g), counting K1's, K2's and K3's launches from zero
   before each path, its host syncs (sync debug mode), its rounds and its
   cross-process calls, bytes and seconds.  Both workers' results must be
   equal, and equal phase 20's one-process four-shard results on every
   field; each kernel must have launched in each worker at least once a
   round per local shard; every solution valid with its givens, the cover
   counts exact.  A worker that fails or outlives its limit fails the
   phase; both are reaped on every exit path.  Printed per path: each
   worker's wall beside phase 20's, rounds, host syncs per round, and the
   cross-process calls, bytes and seconds per round;
23. the seconds the script took, the build's among them, then one JSON
   line ``{"kernels": [...]}`` (launches on the paths, times at the path's
   shape, the plain version's time, the bound; K2 once more for each
   head, P16 once per mask width; K1's and K2's launches include the
   serving, mesh, process-mesh and compile-watch phases', K2's the
   front-door and cluster phases' too, K3's the mesh, process-mesh and
   compile-watch phases'; the bookkeeping kernel's row, BK, counts its
   runs in phases 6 and 9 and is timed at the pentomino shape);
24. the last line, ``{"ok": true, "device": {...}}``.

Tolerance everywhere: exact equality (``max_abs_err`` 0), the kernels being
integer bit algebra.  Exits nonzero without a result where CUDA is absent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

# The op counts that bound the kernels, the compile watch's cost plane's too.
from distributed_sudoku_solver_tpu_torch.ops.cost import round_ops, sweep_ops

REPO = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM at 700 W.  HBM bandwidth, from NVIDIA's data sheet.
# The kernels do 32-bit integer work, which the data sheet does not rate: its
# 67 TFLOP/s float32 rate outside the tensor cores counts an FMA as two ops
# on 128 FP32 lanes per SM; compute capability 9.0 issues 64 32-bit integer
# ops (add, logic, shift, compare, min) per SM per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput), so 67e12 / 2 / 2 int32 ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

SIZES = dict(corpus=65536, k1_boards=32768, k2_lanes=32768, k2_lanes16=8192, composite=4096,
             n6=8192, n12=2048, n16=2048, n25=512, reps=5, cover_lanes=4096, cover_slots=128,
             cover_fanout_steps=160, cover_composite_lanes=1024, head_boards=32768,
             flight_extra=2, snapshot_boards=4096, snapshot_chunk=8, probe_boards=65536,
             probe_iters=16, serving_mass=1024, serving_clients=32, serving_burst=200,
             serving_static=256, serving_bulk=4096, frontdoor_unique=1024, frontdoor_unsat=8,
             cluster_unique=1024, cluster_crash=256, cluster_bulk=4096, mesh_shards=4,
             mesh_composite=4096, mesh_steal_easy=63, mesh_k2=32768, mesh_k2_plain=1024,
             mesh_resident=256, procmesh_procs=2, procmesh_shards=2, procmesh_limit_s=480,
             compile_mass=512, compile_bulk=1024, compile_static=128,
             compile_sync=8, bookkeep_lanes=32768, bookkeep_boards16=4096)

HEAD_RULES = ("head:minrem", "head:cw-slack", "head:mlp")

# Every TPU kernel of the JAX package and its benchmarks (each function
# that reaches pl.pallas_call): its name here, its port's source and the
# TPU kernel it replaces.
KERNELS = {
    "K1": ("K1 propagate_fixpoint", "propagate.cu",
           "distributed_sudoku_solver_tpu/ops/pallas_propagate.py:441"),
    "K2": ("K2 fused_rounds", "fused_step.cu",
           "distributed_sudoku_solver_tpu/ops/pallas_step.py:510"),
    "K3": ("K3 cover_fused_rounds", "cover.cu",
           "distributed_sudoku_solver_tpu/ops/pallas_cover.py:545"),
    "P16": ("P16 fixpoint_probe", "probe_uint16.cu", "benchmarks/probe_uint16.py:94"),
    "PCV": ("PCV cover_probe", "probe_cover.cu", "benchmarks/probe_cover_kernel.py:176"),
}

# Kernels of the port with no TPU kernel to replace: the JAX package does
# their work in XLA ops (here the line of the function that holds them).
PORT_KERNELS = {
    "BK": ("BK fused-loop bookkeeping", "bookkeep.cu",
           "distributed_sudoku_solver_tpu/ops/pallas_step.py:762"),
}

# The counter builds (-DDSST_STAGE_CLOCKS): K2's and K3's stage breakdowns.
COUNTER_TARGETS = (("fused_step", "clocks"), ("cover", "clocks"))
# What --probes builds: the two probe kernels.
PROBE_TARGETS = (("probe_uint16", ""), ("probe_cover", ""))

# Enumeration counts the cover phases must reproduce exactly (OEIS A000170
# for n-queens 14; 2,339 tilings x 4 symmetries for pentomino 6x10).
COVER_COUNTS = {"nqueens14": 365_596, "pentomino6x10": 9_356, "nqueens12": 14_200}


_HARD9_SOLUTIONS: list = []


def hard9_solutions():
    """HARD_9's solutions from the native oracle, computed once (the copied
    pure-Python search, which the tests hold it equal to, takes most of a
    minute on HARD_9[2])."""
    if not _HARD9_SOLUTIONS:
        from distributed_sudoku_solver_tpu_torch import native
        from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

        if not native.available():
            raise AssertionError("the native oracle did not build (g++)")
        _HARD9_SOLUTIONS.extend(native.solve(h)[0] for h in HARD_9)
    return _HARD9_SOLUTIONS


def log(msg: str) -> None:
    print(msg, flush=True)


def _cols_per_row(problem) -> float:
    """Mean number of full columns (primary and secondary) of a row."""
    from distributed_sudoku_solver_tpu_torch.models.cover import _unpack_bits

    return float(_unpack_bits(problem.incidence, problem.n_cols_full).sum(1).mean())


def cover_dispatch_work(problem, top, stack, has_top, base, count, **kw) -> dict:
    """What one cover dispatch's data needs, from a plain run of it.

    ``columns``: the uncovered primary columns of every search pass of every
    live lane (each sweep, and the re-scan after a chain that the cap cut);
    ``loaded``: those of the states whose counts must be made from scratch,
    i.e. each live lane's first round and each round after a pop (every
    other round starts from the state the lane's own take left); ``takes``:
    the rows the sweeps took; ``decrements``: the primary columns of the
    rows that each take (forced, or a branch's guess) killed.  Covered
    columns need no count and are not charged."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import _plain_rounds

    max_sweeps = kw.pop("max_sweeps")
    work = {"sweeps": 0, "columns": 0, "takes": 0, "loaded": 0, "decrements": 0}
    rl = torch.tensor(problem.row_list(), device=top.device)
    primary = ((rl >= 0) & (rl < problem.n_primary)).sum(1).to(torch.int64)  # per row
    shifts = torch.arange(32, device=top.device, dtype=torch.int32)
    undecided = {}  # the previous round's undecided lanes

    def killed_primary(before, after):
        gone = (before & ~after)[:, :, None] >> shifts & 1
        return (gone.flatten(1)[:, :problem.n_rows].to(torch.int64) * primary).sum(1)

    def propagate(states):
        # Dead lanes enter as zeros; a live state never is (it has rows
        # available or columns covered), and the sweep check below holds it.
        active = (states != 0).flatten(1).any(1)
        avail, covered = problem._split(states)
        fresh = active & ~undecided.get("lanes", torch.zeros_like(active))
        work["loaded"] += int((problem._counts(avail, covered)[1] & fresh[:, None]).sum())
        for _ in range(max_sweeps):
            work["sweeps"] += int(active.sum())
            work["columns"] += int((problem._counts(avail, covered)[1] & active[:, None]).sum())
            after, covered, took = problem._forced_take(avail, covered)
            active = active & took
            work["takes"] += int(active.sum())
            work["decrements"] += int(killed_primary(avail, after)[active].sum())
            avail = after
            if not bool(active.any()):
                break
        work["columns"] += int((problem._counts(avail, covered)[1] & active[:, None]).sum())
        return problem.propagate_per_lane(states, max_sweeps)

    def status(tops):
        slv, con = problem.status(tops)
        undecided["lanes"] = (tops != 0).flatten(1).any(1) & ~slv & ~con
        return slv, con

    def branch(tops):
        guess, rest = problem.branch(tops)
        dec = killed_primary(problem._split(tops)[0], problem._split(guess)[0])
        work["decrements"] += int(dec[undecided["lanes"]].sum())
        return guess, rest

    out = _plain_rounds(top, stack, has_top, base, count, propagate, status, branch,
                        words=problem.w_rows, **kw)
    if work["sweeps"] != int(out[11]):
        raise AssertionError(f"the work count saw {work['sweeps']} sweeps, the round {int(out[11])}")
    return work


def cover_dispatch_ops(problem, work: dict, nodes: int, copies: int) -> float:
    """Integer operations of one cover dispatch on its data, with the
    column counts kept from pass to pass: per uncovered column of a loaded
    state, AND, popcount and add per row word; per uncovered column of a
    search pass, one compare (the forced and MRV search); one decrement per
    primary column of a killed row; per row taken (forced, or a branch's
    guess), the lowest row (2 per row word), the take (one OR per row word
    per column of the row, 2 per row word to clear and keep, 1 per covered
    word); 1 per word of each state the stack pushes or pops."""
    wr, wc = problem.w_rows, problem.w_cols
    take = 2 * wr + (_cols_per_row(problem) + 2) * wr + wc
    return (work["loaded"] * 3 * wr + work["columns"] + work["decrements"]
            + (work["takes"] + nodes) * take + copies * (wr + wc))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(fn, reps: int, setup=None) -> float:
    """Mean CUDA-event time of ``fn(setup())`` over ``reps`` runs after one
    warm-up; ``setup`` runs outside the timed region."""
    import torch

    fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def window_ms(averages, match, want: int):
    """Mean device ms per call of one profiled window: the device time of
    the events whose name contains ``match`` (events with device time only,
    so runtime calls never count) over ``want`` calls, with the number of
    events; None for the time when the number is not ``want`` (a window
    that dropped or gained events).  ``match`` may be a tuple of names, for
    a call that launches one kernel of each: then each name must have
    ``want`` events."""
    names = (match,) if isinstance(match, str) else tuple(match)
    events = [e for e in averages
              if any(m in e.key for m in names) and e.self_device_time_total > 0]
    counts = [sum(e.count for e in events if m in e.key) for m in names]
    if any(c != want for c in counts):
        return None, sum(counts)
    return sum(e.self_device_time_total for e in events) / want / 1e3, sum(counts)


# Throwaway launches that open each profiled window of device_ms.
PRIMERS = 16


def device_ms(fn, reps: int, setup, match) -> float:
    """Mean device time per call of the kernels whose name contains
    ``match`` (a name, or a tuple of names: see :func:`window_ms`), over
    ``reps`` calls of ``fn(setup())`` under torch.profiler after one
    warm-up; ``setup`` runs before the profiled region.  Each call launches
    one such kernel of each name, and a window counts only if it recorded
    exactly ``reps`` of each; up to three windows, else AssertionError.
    The profiler loses the first kernel records of a window now and then
    (the first two, on the H100 after a process has run a while), so each
    window opens with ``PRIMERS`` launches of a one-word add and a sync.
    For a kernel shorter than its wrapper's host work, where CUDA events
    around the wrapper would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(setup())
    primer = torch.zeros(1, device="cuda")
    counts = []
    for _ in range(3):
        args = [setup() for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PRIMERS):
                primer.add_(1)
            torch.cuda.synchronize()
            for a in args:
                fn(a)
            torch.cuda.synchronize()
        ms, count = window_ms(prof.key_averages(), match, reps)
        if ms is not None:
            return ms
        counts.append(count)
    raise AssertionError(f"the profiler recorded {counts} events of {match!r} in three windows, "
                         f"not {reps}")


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two tensors' values (uint32 patterns
    compared as unsigned); raises on a shape or dtype mismatch."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.dtype == torch.bool:
        return int((a != b).sum().item() > 0)
    x = a.to(torch.int64)
    y = b.to(torch.int64)
    if a.dtype == torch.int32 and a.ndim >= 2:
        x, y = x & 0xFFFFFFFF, y & 0xFFFFFFFF
    return int((x - y).abs().max().item()) if x.numel() else 0


# -- phases ---------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"[1] device: {name} x{count}")
    log(smi[0])
    return {"kind": name, "count": count, "smi": smi[0]}


def phase_build(targets=None, names=None) -> float:
    """Build the libraries (one nvcc each, all at once; by default every
    target and the counter builds, with the native oracle (``g++``) beside
    them on a thread of its own) and print ptxas's registers, spills and
    stack frame per kernel instantiation of ``names`` (default: every
    source), with the warps an SM holds at that register count (4-warp
    blocks for K1, K2 and the probes, 8 for K3; 64 warps at most).  No
    instantiation may spill."""
    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build

    native_oracle = targets is None
    t0 = time.perf_counter()
    gxx = threading.Thread(target=native.available, name="native-build")
    if native_oracle:
        gxx.start()
    seconds = cuda_build.build(cuda_build.TARGETS + COUNTER_TARGETS if native_oracle
                               else targets)
    if native_oracle:
        gxx.join()
    build_s = time.perf_counter() - t0
    if native_oracle and not native.available():
        raise AssertionError("the native oracle did not build (g++)")
    if seconds:
        if native_oracle:
            seconds["native csp (g++)"] = native.build_seconds or 0.0
        log(f"[2] build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
            f"total {build_s:.2f} s")
    else:
        log("[2] build: every library was built already (phase 21: the nodes' first "
            "requests and the smoke's build beside them)")
    spills = []
    for name in cuda_build.SOURCES if names is None else names:
        block = 256 if name == "cover" else 128  # threads per block
        for row in cuda_build.ptxas_kernels(cuda_build.ptxas_report(name)):
            geo = "" if row["geometry"] is None else f"<{', '.join(map(str, row['geometry']))}>"
            regs = row["registers"]
            warps = min(64, 65536 // (block * (-(-regs // 8) * 8)) * (block // 32))
            log(f"    {name} {row['kernel']}{geo}: {regs} registers, spill stores "
                f"{row['spill_stores']} B, spill loads {row['spill_loads']} B, stack frame "
                f"{row['stack_frame']} B; {warps} warps/SM by registers")
            if row["spill_stores"] or row["spill_loads"]:
                spills.append(f"{row['kernel']}{geo}")
    if spills:
        raise AssertionError(f"kernel instantiations spill: {spills}")
    return build_s


def probe_sass() -> None:
    """``--probes``: each probe kernel's SASS instruction count, and P16's
    sweep loop by opcode."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build

    for lib in ("probe_uint16", "probe_cover"):
        rows = sass_counts(cuda_build.lib_path(lib))
        if not rows:
            log(f"[sass] {lib}: cuobjdump not found (not measured)")
        for fn, row in rows.items():
            loop = (f", {row['loop']} in its sweep loop (the largest without a block barrier); "
                    f"by opcode: {json.dumps(row['loop_ops'])}" if lib == "probe_uint16" else "")
            log(f"[sass] {lib} {fn}: {row['total']} instructions{loop}")


def sass_counts(lib_path) -> dict:
    """Per kernel function of a built library (``cuobjdump -sass``): its
    SASS instruction count, the count inside its largest loop with no block
    barrier in it (the span of that backward branch: P16's sweep loop, its
    refills included) and the instructions there by opcode.
    Empty where the toolkit has no cuobjdump."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    funcs, fn = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            funcs[fn] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if ins and fn is not None:
            funcs[fn].append((int(ins.group(1), 16), ins.group(2).strip()))
    out = {}
    for fn, body in funcs.items():
        barriers = [addr for addr, ins in body if ins.split()[0].startswith("BAR")]
        loop = (0, -1)
        for addr, ins in body:
            bra = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
            target = int(bra.group(1), 16) if bra else addr
            if (target < addr and addr - target > loop[1] - loop[0]
                    and not any(target <= b <= addr for b in barriers)):
                loop = (target, addr)
        inside = [ins for addr, ins in body if loop[0] <= addr <= loop[1]]
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
                                  for i in inside)
        out[fn] = {"total": len(body), "loop": len(inside), "loop_ops": dict(ops.most_common(12))}
    return out


def make_corpus(geom, count: int, seed: int, n_clues=None, hard=()):
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.utils.puzzles import make_puzzle

    boards = [np.asarray(h) for h in hard]
    boards += [make_puzzle(geom, seed + i, n_clues=n_clues, unique=False)
               for i in range(count - len(boards))]
    return np.stack(boards).astype(np.int32)


def phase_corpus(sizes):
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    t0 = time.perf_counter()
    corpus = make_corpus(SUDOKU_9, sizes["corpus"], seed=7, n_clues=24, hard=HARD_9)
    log(f"[3] corpus: {corpus.shape[0]} boards (HARD_9 + 24-clue carved, seed 7) "
        f"in {time.perf_counter() - t0:.2f} s")
    return corpus


def phase_k1(corpus, sizes, dev):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import (
        SUDOKU_6,
        SUDOKU_9,
        SUDOKU_16,
        SUDOKU_25,
        Geometry,
    )
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate as k1
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.propagate import RULE_TIERS, propagate_per_board

    batches = [
        (SUDOKU_9, torch.from_numpy(corpus[: sizes["k1_boards"]])),
        (SUDOKU_6, torch.from_numpy(make_corpus(SUDOKU_6, sizes["n6"], seed=17))),
        (Geometry(3, 4), torch.from_numpy(make_corpus(Geometry(3, 4), sizes["n12"], seed=19))),
        (SUDOKU_16, torch.from_numpy(make_corpus(SUDOKU_16, sizes["n16"], seed=11))),
        (SUDOKU_25, torch.from_numpy(make_corpus(SUDOKU_25, sizes["n25"], seed=13))),
    ]
    err = 0
    for geom, grids in batches:
        cand = encode_grid(grids.to(dev), geom).contiguous()
        for rules in RULE_TIERS:
            got, sw = k1.propagate_fixpoint_cuda(cand, geom, 64, rules)
            want, sw_plain = k1.propagate_fixpoint_plain(cand, geom, 64, rules)
            torch.cuda.synchronize()
            e = max_abs_err(got, want) + abs(int(sw) - int(sw_plain))
            log(f"[4] K1 {geom.n}x{geom.n} B={cand.shape[0]} {rules}: sweeps {int(sw)} "
                f"(plain {int(sw_plain)}) max_abs_err {e}")
            if e:
                raise AssertionError(f"K1 disagrees with its plain version: {geom} {rules}")
            err = max(err, e)

    # Timing at the composite path's shape: its first round propagates the
    # encoded corpus boards, basic rules (phase 7's SolverConfig).
    geom = SUDOKU_9
    cand = encode_grid(torch.from_numpy(corpus[: sizes["composite"]]).to(dev), geom).contiguous()
    def run(c, rules="basic"):
        return k1.propagate_fixpoint_cuda(c, geom, 64, rules)

    # The kernel's device time (profiler): the wrapper's CUDA-event time
    # also holds its host work and the sweep-count max.
    ms = device_ms(run, sizes["reps"], lambda: cand, "propagate_kernel")
    wrapper_ms = event_ms(lambda _: run(cand), sizes["reps"])
    plain_ms = event_ms(lambda _: k1.propagate_fixpoint_plain(cand, geom, 64, "basic"),
                        sizes["reps"])
    _, per_board = propagate_per_board(cand, geom, 64, "basic")
    n_bytes = 2 * cand.numel() * 4 + cand.shape[0] * 4
    n_ops = int(per_board.sum()) * sweep_ops(geom, "basic")
    bms, by = bound_ms(n_bytes, n_ops)
    wide = encode_grid(torch.from_numpy(corpus[: sizes["k1_boards"]]).to(dev), geom).contiguous()
    wide_ms = device_ms(lambda c: run(c, "extended"), sizes["reps"], lambda: wide,
                        "propagate_kernel")
    log(f"[4] K1 timing B={cand.shape[0]} basic: {ms:.4f} ms (kernel, profiler; wrapper "
        f"{wrapper_ms:.4f} ms, CUDA events), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}); "
        f"B={wide.shape[0]} extended: {wide_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def _seeded_frontier(corpus, lanes: int, slots: int, dev, geom=None):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid

    geom = geom or SUDOKU_9
    top = encode_grid(torch.from_numpy(corpus[:lanes]).to(dev), geom).contiguous()
    stack = torch.zeros((lanes, slots, geom.n, geom.n), dtype=torch.int32, device=dev)
    has = torch.ones(lanes, dtype=torch.bool, device=dev)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
    return top, stack, has, zeros, zeros.clone()


def _k2_check(frontier, geom, kw, what: str) -> int:
    """K2 and its plain version on one dispatch; all 13 outputs must agree."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    top, stack, has, base, count = frontier
    got = k2.fused_rounds_cuda(top, stack.clone(), has, base, count, geom, **kw)
    want = k2.fused_rounds_plain(top, stack.clone(), has, base, count, geom, **kw)
    torch.cuda.synchronize()
    e = max(max_abs_err(a, b) for a, b in zip(got, want))
    log(f"[5] K2 {what} {kw['branch_rule']} count_mode={kw['count_mode']}: steps_max "
        f"{int(got[12])} sweeps_total {int(got[11])} nodes {int(got[8].sum())} max_abs_err {e}")
    if e:
        raise AssertionError(f"K2 disagrees with its plain version: {what} {kw}")
    return e


def _k2_timing(frontier, geom, kw, sizes, what: str) -> dict:
    """K2's device time on one dispatch (profiler; the wrapper's CUDA-event
    time beside it), its plain version's, and the bound from this
    dispatch's sweeps, rounds, pushes and pops."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    top, stack, has, base, count = frontier
    lanes = top.shape[0]

    def run(s):
        return k2.fused_rounds_cuda(top, s, has, base, count, geom, **kw)

    ms = device_ms(run, sizes["reps"], stack.clone, "fused_kernel")
    wrapper_ms = event_ms(run, sizes["reps"], setup=stack.clone)
    plain_ms = event_ms(lambda s: k2.fused_rounds_plain(top, s, has, base, count, geom, **kw),
                        2, setup=stack.clone)
    out = k2.fused_rounds_cuda(top, stack.clone(), has, base, count, geom, **kw)
    nodes, live, sweeps_total = out[8], out[10], int(out[11])
    if bool(out[7].any()):
        raise AssertionError("the timed dispatch overflowed; the byte count assumes it does not")
    pushes = int(nodes.sum())
    pops = int((count + nodes - out[4]).sum())
    n2 = geom.n * geom.n
    n_bytes = (3 * lanes * n2 + (pushes + pops) * n2) * 4 + 11 * lanes * 4
    n_ops = sweeps_total * sweep_ops(geom, kw["rules"]) + int(live.sum()) * round_ops(geom)
    bms, by = bound_ms(n_bytes, n_ops)
    log(f"[5] K2 timing {what}: {ms:.4f} ms (kernel, profiler; wrapper {wrapper_ms:.4f} ms, "
        f"CUDA events), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}); pushes {pushes} "
        f"pops {pops} sweeps {sweeps_total}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def phase_k2(corpus, sizes, dev):
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.ops.ordering import LEGACY_RULES

    geom = SUDOKU_9
    lanes, slots, k = sizes["k2_lanes"], 12, 8
    frontier = _seeded_frontier(corpus, lanes, slots, dev)
    what = f"L={lanes} S={slots} k={k}"
    err = 0
    for rule in LEGACY_RULES:
        for count_mode in (False, True):
            kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=k,
                      tile=128, count_mode=count_mode, sweep_unroll=2)
            err = max(err, _k2_check(frontier, geom, kw, what))

    # Timing at the bulk first pass's shape (BulkConfig(): S=12, 8 rounds per
    # dispatch, extended rules, minrem): the first dispatch of the chunk;
    # then the same dispatch on a 16x16 frontier.
    kw = dict(rules="extended", branch_rule="minrem", max_sweeps=64, k_steps=k, tile=128,
              count_mode=False, sweep_unroll=2)
    row = _k2_timing(frontier, geom, kw, sizes, f"9x9 {what}")
    lanes16 = sizes["k2_lanes16"]
    frontier16 = _seeded_frontier(make_corpus(SUDOKU_16, lanes16, seed=23), lanes16, slots, dev,
                                  SUDOKU_16)
    what16 = f"16x16 L={lanes16} S={slots} k={k}"
    err = max(err, _k2_check(frontier16, SUDOKU_16, kw, what16))
    _k2_timing(frontier16, SUDOKU_16, kw, sizes, what16)
    return {"max_abs_err": err, **row}


def phase_breakdown(corpus, sizes, dev) -> dict:
    """K2's counter build at phase 5's shape, minrem and head:mlp: the share
    of each stage in the warps' clock64() cycles ("other": loads, stores and
    loop control outside the stages)."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    lanes, slots = sizes["k2_lanes"], 12
    top, stack, has, base, count = _seeded_frontier(corpus, lanes, slots, dev)
    out = {}
    for rule in ("minrem", "head:mlp"):
        cycles = k2.fused_rounds_stage_cycles(top, stack, has, base, count, SUDOKU_9,
                                              reps=sizes["reps"], branch_rule=rule)
        total = cycles.pop("total")
        cycles["other"] = total - sum(cycles.values())
        shares = {k: round(100 * v / total, 2) for k, v in cycles.items()}
        out[rule] = shares
        log(f"[5] K2 stage breakdown {rule} L={lanes} S={slots} k=8 extended "
            f"(% of {total} warp cycles over {sizes['reps']} launches): {json.dumps(shares)}")
    return out


def phase_times(corpus, sizes, dev) -> dict:
    """Kernel device times (torch.profiler) at the main path's shapes: K1 at
    the composite path's B=4,096 (basic) and at B=32,768 (extended), K2 at
    phase 5's shape with every branch rule and at 16x16, K3 at phase 8's
    three frontiers (count_mode on).  It calls only what
    every slice of the port provides, so a copy of this script run from
    the root of an older checkout times that checkout's kernels (the
    parent-versus-change comparison in PERF.md)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate as k1
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.ordering import LEGACY_RULES

    times = {}
    for boards, rules in ((sizes["composite"], "basic"), (sizes["k1_boards"], "extended")):
        cand = encode_grid(torch.from_numpy(corpus[:boards]).to(dev), SUDOKU_9).contiguous()
        times[f"K1 B={boards} {rules}"] = device_ms(
            lambda c, rules=rules: k1.propagate_fixpoint_cuda(c, SUDOKU_9, 64, rules),
            sizes["reps"], lambda cand=cand: cand, "propagate_kernel")
    lanes16 = sizes["k2_lanes16"]
    frontiers = [(SUDOKU_9, _seeded_frontier(corpus, sizes["k2_lanes"], 12, dev),
                  (*LEGACY_RULES, *HEAD_RULES)),
                 (SUDOKU_16, _seeded_frontier(make_corpus(SUDOKU_16, lanes16, seed=23), lanes16,
                                              12, dev, SUDOKU_16), ("minrem",))]
    for geom, (top, stack, has, base, count), rules in frontiers:
        for rule in rules:
            kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=8, tile=128,
                      count_mode=False, sweep_unroll=2)
            times[f"K2 {geom.n}x{geom.n} L={top.shape[0]} {rule}"] = device_ms(
                lambda st, kw=kw, f=(top, has, base, count), geom=geom: k2.fused_rounds_cuda(
                    f[0], st, f[1], f[2], f[3], geom, **kw),
                sizes["reps"], stack.clone, "fused_kernel")
    for name, problem, (top, stack, has, base, count) in cover_frontiers(sizes, dev):
        kw = dict(max_sweeps=problem.max_sweeps, k_steps=8, tile=128, count_mode=True)
        times[f"K3 {name} L={top.shape[0]}"] = device_ms(
            lambda st, kw=kw, f=(top, has, base, count), p=problem: k3.cover_fused_rounds_cuda(
                f[0], st, f[1], f[2], f[3], p, **kw),
            sizes["reps"], stack.clone, "cover_kernel")
    log(json.dumps({"times_ms": times}))
    return times


def check_solutions(grids, solution, solved, unsat, what: str) -> None:
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution

    if int(unsat.sum()):
        raise AssertionError(f"{what}: {int(unsat.sum())} boards came back unsat")
    if not bool(solved.all()):
        raise AssertionError(f"{what}: {int((~solved).sum())} boards unresolved")
    givens = grids > 0
    if not np.array_equal(solution[givens], grids[givens]):
        raise AssertionError(f"{what}: a solution disagrees with its givens")
    bad = [i for i in range(len(grids)) if not is_valid_solution(solution[i])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} invalid solutions, first {bad[0]}")


def bulk_pass(corpus, dev, inflight: int, traced: bool = True):
    """One timed ``solve_bulk`` pass with ``BulkConfig(inflight=...)``:
    (result, wall seconds to the device sync, trace).  With ``traced``
    false the pass records no span and the trace is None."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk

    trace = {} if traced else None
    t0 = time.perf_counter()
    res = solve_bulk(corpus, SUDOKU_9, BulkConfig(inflight=inflight), trace=trace, device=dev)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, trace


def _stage_line(trace: dict) -> str:
    keys = ("pack_s", "solve_s", "drain_s", "first_pass_s", "chunks", "inflight",
            "remaining_after_first", "k2_dispatches", "host_syncs")
    return json.dumps({k: trace[k] for k in keys if k in trace})


def bulk_turns(corpus, dev, order, ref=None, tag="[6]") -> dict:
    """Bulk passes at each ``inflight`` of ``order`` in turn; each result
    must equal ``ref`` (the first pass's when None).  Returns the walls
    and traces per ``inflight``."""
    import numpy as np

    out: dict = {}
    for inflight in order:
        res, wall, trace = bulk_pass(corpus, dev, inflight)
        ref = ref if ref is not None else res
        for f in ("solution", "solved", "unsat", "by_propagation", "searched"):
            if not np.array_equal(np.asarray(getattr(res, f)), np.asarray(getattr(ref, f))):
                raise AssertionError(f"bulk inflight={inflight}: {f} differs from the first pass")
        out.setdefault(inflight, []).append({"wall_s": wall, **trace, "rungs": len(trace["rungs"]),
                                             "spans": len(trace["spans"])})
        log(f"{tag} bulk inflight={inflight}: {len(corpus)} boards in {wall:.4f} s = "
            f"{len(corpus) / wall:.1f} boards/s; trace {_stage_line(trace)}")
    return out


def phase_main(corpus, dev):
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    _, wall, _ = bulk_pass(corpus, dev, 3, traced=False)
    log(f"[6] bulk pass 1: {wall:.3f} s")

    cuda_step.fused_rounds_cuda.launches = 0
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    cuda_bookkeep.bookkeep_cuda.launches = 0
    res, wall, _ = bulk_pass(corpus, dev, 3, traced=False)
    launches = {"K2": cuda_step.fused_rounds_cuda.launches,
                "K1": cuda_propagate.propagate_fixpoint_cuda.launches,
                "BK": cuda_bookkeep.bookkeep_cuda.launches}
    check_solutions(corpus, res.solution, res.solved, res.unsat, "bulk")
    for i, h in enumerate(HARD_9):
        if not np.array_equal(res.solution[i], hard9_solutions()[i]):
            raise AssertionError(f"bulk: HARD_9[{i}] differs from the oracle's solution")
    if launches["K2"] <= 0:
        raise AssertionError("bulk main path launched K2 no time")
    if launches["BK"] != launches["K2"]:
        raise AssertionError(f"bulk main path: {launches['BK']} runs of the bookkeeping kernel "
                             f"against {launches['K2']} K2 dispatches")
    SINGLE_DEVICE["bulk boards/s"] = len(corpus) / wall
    log(f"[6] bulk pass 2 (inflight=3): {len(corpus)} boards in {wall:.3f} s = "
        f"{len(corpus) / wall:.1f} boards/s; searched {res.searched}, by propagation "
        f"{int(res.by_propagation.sum())}; launches {launches}")
    k2_before = cuda_step.fused_rounds_cuda.launches
    traced, wall_t, trace = bulk_pass(corpus, dev, 3)
    k2 = cuda_step.fused_rounds_cuda.launches - k2_before
    if trace["k2_dispatches"] != k2 or not np.array_equal(traced.solution, res.solution):
        raise AssertionError(f"bulk traced pass: {trace['k2_dispatches']} K2 dispatch spans "
                             f"against {k2} launches, or a solution differs from the untraced pass")
    log(f"[6] bulk pass 3 (inflight=3, traced): {wall_t:.3f} s = {len(corpus) / wall_t:.1f} "
        f"boards/s, {100.0 * (wall_t / wall - 1):+.2f} % of pass 2's wall; trace "
        f"{json.dumps({**trace, 'spans': len(trace['spans'])}, default=str)}")
    bulk_turns(corpus, dev, (1, 3, 1), ref=res)
    return launches


def phase_profile(corpus, dev) -> None:
    """A third bulk pass under torch.profiler: device time by kernel and
    the device's busy share of the pass's host wall clock (the profiler's
    own overhead lengthens that wall, so the share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_bulk(corpus, SUDOKU_9, BulkConfig(), device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    log(f"[6] profile: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall)")
    for key, us, count in rows[:8]:
        log(f"    {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")


def phase_composite(corpus, sizes, dev):
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch

    grids = corpus[: sizes["composite"]]
    cfg = SolverConfig(propagator="pallas")
    cuda_step.fused_rounds_cuda.launches = 0
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    t0 = time.perf_counter()
    res = solve_batch(grids, SUDOKU_9, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": cuda_propagate.propagate_fixpoint_cuda.launches,
                "K2": cuda_step.fused_rounds_cuda.launches}
    check_solutions(grids, res.solution.cpu().numpy(), res.solved.cpu().numpy(),
                    res.unsat.cpu().numpy(), "composite")
    if launches["K1"] <= 0:
        raise AssertionError("composite path launched K1 no time")
    log(f"[7] composite solve_batch: {len(grids)} boards in {wall:.3f} s, steps "
        f"{int(res.steps)}, sweeps {int(res.sweeps)}, steals {int(res.steals)}; "
        f"launches {launches}")
    return launches


def cover_instances(full: bool = True):
    """(name, problem, root states) of the cover phases: n-queens 14 and
    pentomino 6x10 from their single root, sudoku-cover 9x9 from the HARD_9
    clue roots (``full=False`` leaves the sudoku instance out)."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.models.cover import sudoku_clue_rows, sudoku_cover
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    out = []
    for name, problem in (("nqueens14", nqueens_cover(14)),
                          ("pentomino6x10", pentomino_cover(6, 10))):
        out.append((name, problem, problem.initial_state()[None]))
    if full:
        p = sudoku_cover(SUDOKU_9)
        roots = np.stack([p.state_with_rows_taken(sudoku_clue_rows(h)) for h in HARD_9])
        out.append(("sudoku-cover9x9", p, roots))
    return out


def cover_config(**kw):
    """The cover path's configuration (``benchmarks/bench_cover.py``'s width)."""
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig

    base = dict(lanes=SIZES["cover_lanes"], stack_slots=SIZES["cover_slots"],
                max_steps=1_000_000, count_all=True, steal_rounds=4, step_impl="fused")
    return SolverConfig(**{**base, **kw})


def cover_frontiers(sizes, dev):
    """(name, problem, (top, stack, has, base, count)) of phase 8: 4,096-lane
    frontiers of the three cover instances.  n-queens and pentomino grow
    from their one root through fused driver rounds (steals double the live
    lanes each dispatch); sudoku-cover seeds every lane with a HARD_9 clue
    root (cycled, one job each) and runs two dispatches so that stacks
    fill.  Calls only what every version of the cover port provides, so a
    copy of this script builds the same frontiers from an older checkout."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3
    from distributed_sudoku_solver_tpu_torch.ops.frontier import init_frontier

    lanes, k = sizes["cover_lanes"], 8
    out = []
    for name, problem, roots in cover_instances():
        cfg = cover_config()
        steps = sizes["cover_fanout_steps"]
        if roots.shape[0] > 1:
            roots = np.resize(roots, (lanes, *roots.shape[1:]))
            steps = 2 * k
        state = init_frontier(torch.from_numpy(roots).to(dev), cfg)
        state = k3.advance_cover_fused(state, steps, problem, cfg)
        frontier = (state.top, state.stack, state.has_top, state.base, state.count)
        log(f"[8] K3 {name} L={lanes} S={state.stack.shape[1]} D={state.top.shape[-1]}: "
            f"after {int(state.steps)} steps {int(state.has_top.sum())} lanes live, mean "
            f"stack {float(state.count.float().mean()):.1f}")
        out.append((name, problem, frontier))
    return out


def phase_k3(frontiers, sizes, dev):
    """K3 against its plain version on phase 8's frontiers, count_mode off
    and on; timing is at the enumeration path's mode (count_mode on)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3

    lanes, k = sizes["cover_lanes"], 8
    err, rows = 0, {}
    for name, problem, (top, stack, has, base, count) in frontiers:
        for count_mode in (False, True):
            kw = dict(max_sweeps=problem.max_sweeps, k_steps=k, tile=128,
                      count_mode=count_mode)
            got = k3.cover_fused_rounds_cuda(top, stack.clone(), has, base, count, problem, **kw)
            want = k3.cover_fused_rounds_plain(top, stack.clone(), has, base, count, problem,
                                               **kw)
            torch.cuda.synchronize()
            e = max(max_abs_err(a, b) for a, b in zip(got, want))
            log(f"[8] K3 {name} count_mode={count_mode}: steps_max {int(got[12])} "
                f"sweeps_total {int(got[11])} nodes {int(got[8].sum())} sols "
                f"{int(got[9].sum())} max_abs_err {e}")
            if e:
                raise AssertionError(f"K3 disagrees with its plain version: {name} {count_mode}")
            err = max(err, e)

        kw = dict(max_sweeps=problem.max_sweeps, k_steps=k, tile=128, count_mode=True)

        def run(st):
            return k3.cover_fused_rounds_cuda(top, st, has, base, count, problem, **kw)

        ms = device_ms(run, sizes["reps"], stack.clone, "cover_kernel")
        wrapper_ms = event_ms(run, sizes["reps"], setup=stack.clone)
        plain_ms = event_ms(lambda st: k3.cover_fused_rounds_plain(top, st, has, base, count,
                                                                  problem, **kw),
                            1, setup=stack.clone)
        out = k3.cover_fused_rounds_cuda(top, stack.clone(), has, base, count, problem, **kw)
        nodes, live, sweeps_total = out[8], out[10], int(out[11])
        if bool(out[7].any()):
            raise AssertionError("the timed dispatch overflowed; the byte count assumes it does not")
        pushes = int(nodes.sum())
        pops = int((count + nodes - out[4]).sum())
        d = top.shape[-1]
        consts = problem.n_cols_full * problem.w_rows + problem.row_list().size
        n_bytes = (3 * lanes * d + (pushes + pops) * d + consts) * 4 + 11 * lanes * 4
        work = cover_dispatch_work(problem, top, stack.clone(), has, base, count, **kw)
        n_ops = cover_dispatch_ops(problem, work, pushes, pushes + pops)
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"[8] K3 timing {name} L={lanes} count_mode: {ms:.4f} ms (kernel, profiler; "
            f"wrapper {wrapper_ms:.4f} ms, CUDA events), plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({by}); "
            f"pushes {pushes} pops {pops} sweeps {sweeps_total} (forced takes "
            f"{work['takes']}, uncovered columns searched {work['columns']} of "
            f"{sweeps_total * problem.n_primary}, counted from scratch {work['loaded']}, "
            f"decrements {work['decrements']}) live rounds {int(live.sum())}")
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
    return err, rows


def phase_cover_breakdown(frontiers, sizes) -> dict:
    """K3's counter build on phase 8's frontiers (k_steps=8, count_mode on):
    each stage's share of the warps' clock64() cycles ("other": output
    stores and loop control outside the stages), and the longest warp's
    cycles against the mean warp's (the dispatch waits for the longest)."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover as k3

    out = {}
    for name, problem, (top, stack, has, base, count) in frontiers:
        cycles = k3.cover_fused_rounds_stage_cycles(
            top, stack, has, base, count, problem, reps=sizes["reps"],
            max_sweeps=problem.max_sweeps, k_steps=8, count_mode=True)
        longest = cycles.pop("longest warp")
        total = cycles.pop("total")
        cycles["other"] = total - sum(cycles.values())
        shares = {k: round(100 * v / total, 2) for k, v in cycles.items()}
        mean = total / (sizes["reps"] * top.shape[0])
        out[name] = dict(shares, total=total, longest=longest, mean=mean)
        log(f"[8] K3 stage breakdown {name} L={top.shape[0]} S={stack.shape[1]} k=8 count_mode "
            f"(% of {total} warp cycles over {sizes['reps']} launches): {json.dumps(shares)}; "
            f"longest warp {longest} cycles, mean warp {mean:.0f} ({longest / mean:.2f}x)")
    return out


def _check_cover_solution(name, problem, solution) -> None:
    from distributed_sudoku_solver_tpu_torch.models.nqueens import decode_queens, is_valid_queens
    from distributed_sudoku_solver_tpu_torch.models.pentomino import decode_tiling, is_valid_tiling

    if name.startswith("nqueens"):
        n = int(name[len("nqueens"):])
        ok = is_valid_queens(decode_queens(problem, solution, n), n)
    else:
        ok = is_valid_tiling(decode_tiling(problem, solution, 6, 10))
    if not ok:
        raise AssertionError(f"{name}: the first solution found does not decode to a valid one")


def phase_cover_main(dev):
    """The cover path at full width: fused enumerations, second run timed."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import (
        cuda_bookkeep,
        cuda_cover,
        cuda_propagate,
        cuda_step,
    )
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp

    cfg = cover_config()
    launches, bookkeep = {}, {}
    for name, problem, roots in cover_instances(full=False):
        t0 = time.perf_counter()
        solve_csp(roots, problem, cfg, device=dev)
        torch.cuda.synchronize()
        log(f"[9] {name} run 1: {time.perf_counter() - t0:.3f} s")
        cuda_cover.cover_fused_rounds_cuda.launches = 0
        cuda_step.fused_rounds_cuda.launches = 0
        cuda_propagate.propagate_fixpoint_cuda.launches = 0
        cuda_bookkeep.bookkeep_cuda.launches = 0
        t0 = time.perf_counter()
        res = solve_csp(roots, problem, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = cuda_cover.cover_fused_rounds_cuda.launches
        others = cuda_step.fused_rounds_cuda.launches + cuda_propagate.propagate_fixpoint_cuda.launches
        count = int(res.sol_count[0])
        if count != COVER_COUNTS[name]:
            raise AssertionError(f"{name}: counted {count}, expected {COVER_COUNTS[name]}")
        if not bool(res.unsat[0]) or bool(res.overflowed[0]):
            raise AssertionError(f"{name}: not exhausted ({bool(res.unsat[0])}) or overflowed "
                                 f"({bool(res.overflowed[0])})")
        if n <= 0 or others:
            raise AssertionError(f"{name}: K3 launched {n} times, K1/K2 {others} times")
        if cuda_bookkeep.bookkeep_cuda.launches != n:
            raise AssertionError(f"{name}: {cuda_bookkeep.bookkeep_cuda.launches} runs of the "
                                 f"bookkeeping kernel against {n} K3 dispatches")
        _check_cover_solution(name, problem, res.solution[0])
        launches[name] = n
        bookkeep[name] = cuda_bookkeep.bookkeep_cuda.launches
        SINGLE_DEVICE[f"cover {name}"] = wall
        log(f"[9] {name} run 2: {count} solutions in {wall:.3f} s = {count / wall:.1f} "
            f"solutions/s; dispatches {n}, steps {int(res.steps)}, nodes "
            f"{int(res.nodes[0])}, sweeps {int(res.sweeps)}, steals {int(res.steals)}")
    return launches, bookkeep


def phase_cover_profile(dev) -> None:
    """n-queens 14 once more under torch.profiler: device time by kernel and
    the device's busy share of the host wall clock (a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp

    name, problem, roots = cover_instances(full=False)[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_csp(roots, problem, cover_config(), device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    log(f"[9] profile {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall)")
    for key, us, count in rows[:8]:
        log(f"    {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")


# The three kernels of csrc/bookkeep.cu, one launch of each a bookkeeping.
BOOKKEEP_KERNELS = ("harvest_kernel", "purge_kernel", "steal_fold_kernel")


def bookkeep_bytes(before, kout, after, clear_words: int) -> int:
    """Bytes one run of the fused loop's bookkeeping has to move, from its
    frontier ``before`` and ``after`` and the round's ``kout``: per lane
    the eight ``lane_out`` words, ``job`` and ``base`` read, ``lane_rounds``
    read and written, ``has_top`` and ``count`` written (53); per job
    ``nodes`` and ``sol_count`` read and written, ``solved`` and
    ``overflowed`` read and written (20); and the rows that change: each
    dead lane's cleared words, each stolen row read from the stack and
    written to the thief's top, each solution row written (and read from
    the lanes' solutions)."""
    lanes, jobs = before.has_top.shape[0], before.solved.shape[0]
    words = before.top[0].numel()
    tile = min(kout.tile, lanes)
    live = kout.lane_out[6]
    most = live.view(-1, tile).amax(1).repeat_interleave(tile)
    dead = int((live < most).sum())
    stolen = int(after.steals - before.steals)
    solutions = int((after.solution != before.solution).flatten(1).any(1).sum())
    rows = dead * clear_words + 2 * (stolen + solutions) * words
    return 53 * lanes + 20 * jobs + 4 * rows


def _bookkeep_case(what, fs, kout, config, sizes):
    """The bookkeeping kernel and its plain version on one real dispatch
    (``fs`` before it, ``kout`` the round kernel's outputs): every field,
    the next top, the flag and the gated ``has_top`` bit-equal; both again
    with the flag false at entry (a spare dispatch), each leaving every
    buffer as it was; then the kernel's device time (torch.profiler, its
    three launches a call), the plain version's and the bound by bytes."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep

    lanes, jobs, dev = fs.has_top.shape[0], fs.solved.shape[0], fs.has_top.device
    limit = fs.steps.to(torch.int64) + 1_000_000

    def fresh(go=True):  # the stack is only read, so it is shared
        return (type(fs)(*(t if t is fs.stack else t.clone() for t in fs)),
                kout._replace(top=kout.top.clone()), cuda_bookkeep.new_work(lanes, jobs, dev),
                torch.full((), go, dtype=torch.bool, device=dev),  # the flag at entry
                fs.has_top.to(torch.int32))  # the gate, as the loop's load leaves it

    def fields(args):
        return list(zip(args[0]._fields, args[0]._replace(top=args[1].top))) + [
            ("go", args[3]), ("gate", args[4])]

    def disagree(got, want):
        errs = {name: max_abs_err(a, b) for (name, a), (_, b) in zip(fields(got), fields(want))}
        return {k: v for k, v in errs.items() if v}

    got, want = fresh(), fresh()
    cuda_bookkeep.bookkeep_cuda(got[0], got[1], limit, got[3], got[2], config, got[4])
    cuda_bookkeep.bookkeep_plain(want[0], want[1], limit, want[3], None, config, want[4])
    torch.cuda.synchronize()
    pairs = fields(got)
    errs = disagree(got, want)
    if errs:
        raise AssertionError(f"the bookkeeping kernel disagrees with its plain version, {what}: "
                             f"{errs}")
    before, spare_got, spare_want = fresh(False), fresh(False), fresh(False)
    cuda_bookkeep.bookkeep_cuda(spare_got[0], spare_got[1], limit, spare_got[3], spare_got[2],
                                config, spare_got[4])
    cuda_bookkeep.bookkeep_plain(spare_want[0], spare_want[1], limit, spare_want[3], None, config,
                                 spare_want[4])
    torch.cuda.synchronize()
    for side, args in (("kernel", spare_got), ("plain version", spare_want)):
        errs = disagree(args, before)
        if side == "kernel" and max_abs_err(args[2], before[2]):
            errs["work"] = max_abs_err(args[2], before[2])
        if errs:
            raise AssertionError(f"the bookkeeping {side} changed buffers with the flag false at "
                                 f"entry, {what}: {errs}")
    after = got[0]
    n_bytes = bookkeep_bytes(fs, kout, after, kout.words)

    def run(args):
        cuda_bookkeep.bookkeep_cuda(args[0], args[1], limit, args[3], args[2], config, args[4])

    ms = device_ms(run, sizes["reps"], fresh, BOOKKEEP_KERNELS)
    plain_ms = event_ms(lambda a: cuda_bookkeep.bookkeep_plain(a[0], a[1], limit, a[3], None,
                                                               config, a[4]),
                        2, setup=fresh)
    bms, by = bound_ms(n_bytes, 0)
    log(f"[9] bookkeeping {what}: bit-equal (max_abs_err 0 on {len(pairs)} fields), and "
        f"nothing changed with the flag false at entry; "
        f"{int(fs.has_top.sum())} lanes live before, {int(after.has_top.sum())} after, steals "
        f"{int(after.steals - fs.steals)}, go {bool(got[3])}; {ms:.4f} ms (3 kernels, "
        f"profiler), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}, {n_bytes} B)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def phase_bookkeep(sizes, dev) -> dict:
    """The fused loop's bookkeeping kernel against its plain version on a
    real dispatch at each main path's shape: ``cover-pentomino``'s (6x10
    pentomino, 32,768 lanes, one job, S=128, count mode, steals) and
    ``sudoku16-bulk``'s first pass (32,768 16x16 boards, one job a lane,
    S=12, k=8, extended rules, minrem), each frontier fanned out by fused
    dispatches first.  Returns the cover case's row."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, init_frontier

    lanes = sizes["bookkeep_lanes"]
    problem = pentomino_cover(6, 10)
    cfg = cover_config(lanes=lanes).with_fused_steps(cuda_cover.FUSED_STEPS_LINKED)
    state = init_frontier(torch.from_numpy(problem.initial_state()[None]).to(dev), cfg)
    fs = cuda_cover.advance_cover_fused(state, sizes["cover_fanout_steps"], problem, cfg)
    kout = cuda_cover._rounds_fn(problem, cfg, lanes)(fs, out=cuda_step._out_buffers(fs.top))
    cover = _bookkeep_case(f"pentomino6x10 L={lanes} J=1 S={fs.stack.shape[1]} "
                           f"D={fs.top[0].numel()}", fs, kout, cfg, sizes)
    del state, fs, kout

    grids = make_corpus(SUDOKU_16, sizes["bookkeep_boards16"], seed=29)
    grids = np.resize(grids, (lanes, *grids.shape[1:]))
    cfg = SolverConfig(lanes=lanes, stack_slots=12, max_steps=100_000, rules="extended",
                       step_impl="fused", fused_steps=8)
    state = init_frontier(encode_grid(torch.from_numpy(grids).to(dev), SUDOKU_16), cfg)
    fs = cuda_step.advance_frontier_fused(state, 16, SUDOKU_16, cfg)
    kout = cuda_step._rounds_fn(SUDOKU_16, cfg, lanes)(fs, out=cuda_step._out_buffers(fs.top))
    _bookkeep_case(f"16x16 L=J={lanes} S=12 k=8", fs, kout, cfg, sizes)
    return cover


def phase_cover_composite(sizes, dev):
    """The composite cover path: an n-queens 12 count and the HARD_9 boards
    solved as exact cover, each against the native oracle."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.cover import (
        decode_sudoku_cover,
        sudoku_clue_rows,
        sudoku_cover,
    )
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    cuda_cover.cover_fused_rounds_cuda.launches = 0
    p = nqueens_cover(12)
    cfg = cover_config(lanes=sizes["cover_composite_lanes"], step_impl="xla")
    t0 = time.perf_counter()
    res = solve_csp(p.initial_state()[None], p, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = int(res.sol_count[0])
    if count != COVER_COUNTS["nqueens12"] or not bool(res.unsat[0]) or bool(res.overflowed[0]):
        raise AssertionError(f"composite nqueens12: counted {count}, unsat "
                             f"{bool(res.unsat[0])}, overflowed {bool(res.overflowed[0])}")
    log(f"[10] composite nqueens12: {count} solutions in {wall:.3f} s, steps "
        f"{int(res.steps)}, sweeps {int(res.sweeps)}, nodes {int(res.nodes[0])}")

    p = sudoku_cover(SUDOKU_9)
    roots = np.stack([p.state_with_rows_taken(sudoku_clue_rows(h)) for h in HARD_9])
    t0 = time.perf_counter()
    res = solve_csp(roots, p, SolverConfig(min_lanes=64, stack_slots=64), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, h in enumerate(HARD_9):
        grid = decode_sudoku_cover(p, res.solution[i], 9)
        if not bool(res.solved[i]) or not np.array_equal(grid, hard9_solutions()[i]):
            raise AssertionError(f"sudoku-cover: HARD_9[{i}] differs from the oracle's solution")
    if cuda_cover.cover_fused_rounds_cuda.launches:
        raise AssertionError("the composite cover path launched K3")
    log(f"[10] composite sudoku-cover HARD_9: {len(HARD_9)} boards solved in {wall:.3f} s, "
        f"steps {int(res.steps)}, nodes {int(res.nodes.sum())}; all equal the oracle")


def head_score_ops(rule: str, n: int) -> tuple[int, int, int]:
    """A head's work on top of phase 5's round, counted on the plain
    algorithm: (int32 ops per branch: the unit sums, 4 per cell per unit
    type; int32 ops per undecided cell: unpacking 3 unit words, the peer
    and feature differences, the key and the min; float ops per undecided
    cell: conversions, the score, the quantization and its clamp)."""
    per_branch = 3 * n * n * 4
    if rule == "head:minrem":
        return per_branch, 3 + 6, 1 + 5
    if rule == "head:cw-slack":
        return per_branch, 6 + 5 + 3, 4 + 5
    # 7 features (convert + scale), 8 hidden units of 7 products, 6 sums,
    # the bias and the ReLU, 8 output products and 7 sums, the bias.
    return per_branch, 6 + 6 + 3, 7 + 7 + 8 * (7 + 6 + 2) + 8 + 7 + 1 + 5


def head_dispatch_work(top, stack, has, base, count, geom, rule, k) -> dict:
    """Branches and undecided cells one head dispatch scores on this data,
    from a plain replay of it (a dead lane enters as zeros, a contradiction,
    and is not counted)."""
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import popcount
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
        _plain_rounds,
        head_branch_full,
        status_full,
    )
    from distributed_sudoku_solver_tpu_torch.ops.propagate import propagate_per_board

    work = {"branches": 0, "cells": 0}

    def branch(tops):
        solved, contra = status_full(tops, geom)
        und = ~solved & ~contra
        work["branches"] += int(und.sum())
        work["cells"] += int(((popcount(tops) > 1) & und[:, None, None]).sum())
        return head_branch_full(tops, geom, rule)

    out = _plain_rounds(top, stack, has, base, count,
                        lambda b: propagate_per_board(b, geom, 64, "extended", unroll=2),
                        lambda b: status_full(b, geom), branch, k, 128, False,
                        geom.n * geom.n)
    if work["branches"] != int(out[8].sum()):
        raise AssertionError(f"the work count saw {work['branches']} branches, the round "
                             f"{int(out[8].sum())}")
    return work


def phase_k2_heads(corpus, sizes, dev):
    """K2 with each scored head against its plain version at phase 5's
    shape; device time from the profiler, the plain version's time, the
    bound (a float op counts as half an int32 op: the H100's non-FMA f32
    rate is twice its int32 rate)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step as k2

    geom = SUDOKU_9
    lanes, slots, k = sizes["k2_lanes"], 12, 8
    top, stack, has, base, count = _seeded_frontier(corpus, lanes, slots, dev)
    rows = {}
    for rule in HEAD_RULES:
        kw = dict(rules="extended", branch_rule=rule, max_sweeps=64, k_steps=k, tile=128,
                  count_mode=False, sweep_unroll=2)
        got = k2.fused_rounds_cuda(top, stack.clone(), has, base, count, geom, **kw)
        want = k2.fused_rounds_plain(top, stack.clone(), has, base, count, geom, **kw)
        torch.cuda.synchronize()
        e = max(max_abs_err(a, b) for a, b in zip(got, want))
        log(f"[11] K2 L={lanes} S={slots} k={k} {rule}: steps_max {int(got[12])} sweeps_total "
            f"{int(got[11])} nodes {int(got[8].sum())} max_abs_err {e}")
        if e:
            raise AssertionError(f"K2 disagrees with its plain version: {rule}")

        def run(st, kw=kw):
            return k2.fused_rounds_cuda(top, st, has, base, count, geom, **kw)

        ms = device_ms(run, sizes["reps"], stack.clone, "fused_kernel")
        plain_ms = event_ms(lambda st, kw=kw: k2.fused_rounds_plain(top, st, has, base, count,
                                                                   geom, **kw),
                            1, setup=stack.clone)
        nodes, live, sweeps_total = got[8], got[10], int(got[11])
        if bool(got[7].any()):
            raise AssertionError("the dispatch overflowed; the byte count assumes it does not")
        pushes = int(nodes.sum())
        pops = int((count + nodes - got[4]).sum())
        n2 = geom.n * geom.n
        n_bytes = (3 * lanes * n2 + (pushes + pops) * n2) * 4 + 11 * lanes * 4
        work = head_dispatch_work(top, stack.clone(), has, base, count, geom, rule, k)
        per_branch, int_cell, float_cell = head_score_ops(rule, geom.n)
        n_ops = (sweeps_total * sweep_ops(geom, "extended") + int(live.sum()) * round_ops(geom)
                 + work["branches"] * per_branch + work["cells"] * (int_cell + float_cell / 2))
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"[11] K2 timing {rule}: {ms:.4f} ms (kernel, profiler), plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({by}); branches {work['branches']} undecided cells scored "
            f"{work['cells']}")
        rows[rule] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": by}
    return rows


def phase_heads_main(corpus, sizes, dev):
    """``solve_batch(step_impl="fused")`` at full width with minrem and
    each head; returns (launches per head, minrem's nodes per board)."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    grids = corpus[: sizes["head_boards"]]
    base = dict(step_impl="fused", rules="extended")
    solve_batch(grids, SUDOKU_9, SolverConfig(**base), device=dev)  # warm-up
    torch.cuda.synchronize()
    results, launches = {}, {}
    for rule in ("minrem", *HEAD_RULES):
        cuda_step.fused_rounds_cuda.launches = 0
        t0 = time.perf_counter()
        res = solve_batch(grids, SUDOKU_9, SolverConfig(branch=rule, **base), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[rule] = cuda_step.fused_rounds_cuda.launches
        res = res._replace(**{f: getattr(res, f).cpu() for f in res._fields})
        check_solutions(grids, res.solution.numpy(), res.solved.numpy(), res.unsat.numpy(),
                        f"heads {rule}")
        for i, h in enumerate(HARD_9):
            if not np.array_equal(res.solution[i].numpy(), hard9_solutions()[i]):
                raise AssertionError(f"{rule}: HARD_9[{i}] differs from the oracle's solution")
        if launches[rule] <= 0:
            raise AssertionError(f"{rule}: the head path launched K2 no time")
        results[rule] = res
        log(f"[12] {rule}: {len(grids)} boards in {wall:.3f} s = {len(grids) / wall:.1f} boards/s; "
            f"nodes {int(res.nodes.sum())}, steps {int(res.steps)}, steals {int(res.steals)}; "
            f"K2 launches {launches[rule]}")
    ref, same = results["minrem"], results["head:minrem"]
    if not (torch.equal(same.nodes, ref.nodes) and int(same.steps) == int(ref.steps)):
        raise AssertionError("head:minrem's nodes or steps differ from minrem's")
    return launches, ref.nodes.numpy()


def _count_syncs(fn, counts=None, stage=None):
    """``fn()``; with ``counts``, its host syncs (torch's sync debug mode)
    are added to ``counts[stage]``."""
    import torch

    if counts is None:
        return fn()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts[stage] = counts.get(stage, 0) + sum("synchroniz" in str(w.message) for w in seen)
    return out


def _fly(mailbox, board, cfg, dev, syncs=None):
    """One latency flight: attach -> megastep -> status word and verdict
    payload in one transfer -> detach.  Returns (mailbox, verdict); with
    ``syncs`` (a dict), each stage's host syncs are counted into it."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import advance_megastep_fused
    from distributed_sudoku_solver_tpu_torch.ops.frontier import (
        attach_roots,
        detach,
        status_len,
        unpack_status,
    )

    def attach():
        root = encode_grid(torch.from_numpy(board[None]).to(dev), SUDOKU_9)
        return attach_roots(mailbox, root, torch.zeros(1, dtype=torch.int32, device=dev),
                            cfg.steal_gang)

    mailbox = _count_syncs(attach, syncs, "attach")
    mailbox, status, chunks = _count_syncs(
        lambda: advance_megastep_fused(mailbox, 64, 64, SUDOKU_9, cfg), syncs, "advance")
    payload = _count_syncs(
        lambda: torch.cat([status, mailbox.nodes, mailbox.sol_count,
                           mailbox.overflowed.to(torch.int32),
                           decode_grid(mailbox.solution).flatten()]).cpu().numpy(),
        syncs, "fetch")
    mailbox = _count_syncs(
        lambda: detach(mailbox, torch.ones(1, dtype=torch.bool, device=dev)), syncs, "detach")
    w = status_len(1)
    info = unpack_status(payload[:w], 1)
    verdict = dict(solved=bool(info["solved"][0]), has_work=bool(info["has_work"][0]),
                   chunks=chunks, nodes=int(payload[w]), overflowed=bool(payload[w + 2]),
                   solution=payload[w + 3:].reshape(9, 9), steps=info["steps"])
    return mailbox, verdict


def phase_flight(corpus, minrem_nodes, sizes, dev):
    """The latency flight, shaped as the serving megastep shapes it."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, init_frontier_roots
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_one
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    gang = 8  # MegastepConfig(): gang_lanes 8, chunk_steps 64, max_chunks 64
    cfg = SolverConfig(step_impl="fused", branch="head:cw-slack", lanes=gang, min_lanes=gang,
                       steal_gang=gang, max_steps=(1 << 31) - 1)
    mailbox = init_frontier_roots(torch.zeros((gang, 9, 9), dtype=torch.int32, device=dev),
                                  torch.full((gang,), -1, dtype=torch.int32, device=dev), 1, cfg)
    hard = [int(i) for i in np.argsort(-minrem_nodes[len(HARD_9):])[: sizes["flight_extra"]]]
    boards = [(f"HARD_9[{i}]", np.asarray(h, np.int32)) for i, h in enumerate(HARD_9)]
    boards += [(f"corpus[{i + len(HARD_9)}]", corpus[i + len(HARD_9)]) for i in hard]
    mailbox, _ = _fly(mailbox, boards[0][1], cfg, dev)  # warm-up, the loop's graph captured
    rows, launches = [], 0
    for name, board in boards:
        torch.cuda.synchronize()
        cuda_step.fused_rounds_cuda.launches = 0
        built = cuda_step._GRAPHS.built
        t0 = time.perf_counter()
        mailbox, v = _fly(mailbox, board, cfg, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        captures = cuda_step._GRAPHS.built - built
        launches += cuda_step.fused_rounds_cuda.launches
        # The same flight again, its host syncs counted by stage, then the reference.
        syncs = {}
        mailbox, again = _fly(mailbox, board, cfg, dev, syncs)
        sol, res = solve_one(board, SUDOKU_9, cfg, device=dev)
        unsat = not v["solved"] and not v["has_work"] and not v["overflowed"]
        if v["has_work"] or v["solved"] != bool(res.solved[0]) or unsat != bool(res.unsat[0]):
            raise AssertionError(f"flight {name}: verdict differs from solve_one's")
        if sol is not None and not np.array_equal(v["solution"], sol):
            raise AssertionError(f"flight {name}: solution differs from solve_one's")
        if v["nodes"] != int(res.nodes[0]) or again["solution"].tolist() != v["solution"].tolist():
            raise AssertionError(f"flight {name}: nodes or a repeated flight differ")
        rows.append(dict(board=name, wall_ms=wall_ms, chunks=v["chunks"], syncs=syncs,
                         nodes=v["nodes"], solved=v["solved"], graph_captures=captures))
        log(f"[13] flight {name}: {wall_ms:.3f} ms, chunks {v['chunks']}, host syncs "
            f"{sum(syncs.values())} {json.dumps(syncs)}, nodes {v['nodes']}, steps "
            f"{v['steps']}, solved {v['solved']}, graph captures in the timed flight "
            f"{captures}; equals solve_one")
    if launches <= 0:
        raise AssertionError("the flights launched K2 no time")
    return launches, rows


class _Interrupt(Exception):
    pass


def _interrupt(_state):
    raise _Interrupt


def phase_snapshot(corpus, sizes, dev):
    """A checkpointed solve interrupted after its first chunk and resumed
    from the snapshot on disk, against one never interrupted."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.utils.checkpoint import solve_batch_checkpointed

    grids = corpus[: sizes["snapshot_boards"]]
    cfg = SolverConfig(propagator="pallas")
    kw = dict(chunk_steps=sizes["snapshot_chunk"], device=dev)
    t0 = time.perf_counter()
    whole = solve_batch_checkpointed(grids, SUDOKU_9, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frontier.npz")
        try:
            solve_batch_checkpointed(grids, SUDOKU_9, cfg, checkpoint_path=path,
                                     on_chunk=_interrupt, **kw)
            raise AssertionError("the checkpointed solve finished within its first chunk")
        except _Interrupt:
            pass
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        resumed = solve_batch_checkpointed(grids, SUDOKU_9, cfg, checkpoint_path=path, **kw)
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        if os.path.exists(path):
            raise AssertionError("the snapshot was not removed on completion")
    bad = [f for f in whole._fields if not torch.equal(getattr(whole, f), getattr(resumed, f))]
    if bad:
        raise AssertionError(f"the resumed solve differs from the uninterrupted one in {bad}")
    check_solutions(grids, resumed.solution.cpu().numpy(), resumed.solved.cpu().numpy(),
                    resumed.unsat.cpu().numpy(), "snapshot resume")
    log(f"[14] snapshot: {len(grids)} boards, {int(whole.steps)} steps; uninterrupted "
        f"{wall:.3f} s, resumed after step {sizes['snapshot_chunk']} from a {size} byte "
        f"snapshot in {resume_wall:.3f} s; bit-identical on every field")


def warp_divergence(sweeps, boards_per_warp: int) -> float:
    """Mean over warps of the warp's largest sweep count, over the mean
    count: what a warp that loops a fixed group of consecutive boards (32
    at 32 bits, 64 at 16: two a lane) sweeps per sweep its boards need."""
    import torch

    s = sweeps.to(torch.float64).flatten()
    pad = (-s.numel()) % boards_per_warp
    groups = torch.cat([s, s.new_zeros(pad)]).reshape(-1, boards_per_warp)
    return float(groups.max(1).values.mean() / s.mean())


def queue_model(sweeps, tile: int, threads: int = 128, per_lane: int = 1) -> dict:
    """P16's queue as a model: each tile of ``tile`` consecutive boards goes
    to one block of ``threads`` lanes with ``per_lane`` board slots each (2
    at 16 bits); slot s of lane l starts with board ``s * threads + l``, and
    a slot that finishes a board takes the tile's next one.  Returns the
    most sweeps a warp runs on one tile (the slowest block's time, in
    sweeps) and the warp-iterations times the warp's slots over the boards'
    sweeps (the divergence the queue leaves)."""
    import heapq

    import numpy as np

    s = np.asarray(sweeps, dtype=np.int64).ravel()
    slots = threads * per_lane
    warp_of = (np.arange(slots) % threads) // 32
    worst, warp_iters = 0, 0
    for t0 in range(0, s.size, tile):
        heap = [(0, i) for i in range(slots)]
        finish = np.zeros(slots, dtype=np.int64)
        for need in s[t0:t0 + tile]:
            at, i = heapq.heappop(heap)
            finish[i] = at + need
            heapq.heappush(heap, (int(finish[i]), i))
        per_warp = np.zeros(threads // 32, dtype=np.int64)
        np.maximum.at(per_warp, warp_of, finish)
        worst = max(worst, int(per_warp.max()))
        warp_iters += int(per_warp.sum())
    return {"max_warp_sweeps": worst,
            "divergence": warp_iters * 32 * per_lane / float(s.sum())}


def phase_p16(sizes, dev):
    """P16 against its plain version, then the uint16 probe's own run (its
    launches counted from zero) and each mask width's device time; beside
    them the input's per-warp divergence and the queue's model of it.  It
    calls only what every slice of the port provides, so a copy of this
    script in an older checkout measures that checkout's kernel
    (``--probes``)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.probes import uint16 as p16

    batch = sizes["probe_boards"]
    cand32 = p16.probe_boards(batch).to(dev)
    widths = {"uint32": torch.int32, "uint16": torch.int16}
    err = 0
    for name, dtype in widths.items():
        x = cand32.to(dtype)
        for cap, xx in ((64, x), (1, x), (2, x), (64, x[..., : batch - 1].contiguous())):
            got = p16.fixpoint_probe_cuda(xx, cap)
            want = p16.fixpoint_probe_plain(xx, cap)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            log(f"[15] P16 {name} T={xx.shape[2]} max_sweeps={cap}: max_abs_err {e}")
            if e:
                raise AssertionError(f"P16 disagrees with its plain version: {name} {cap}")
            err = max(err, e)

    p16.fixpoint_probe_cuda.launches = 0
    out = p16.run_probe(batch, sizes["probe_iters"], reps=3, device=dev)
    launches = p16.fixpoint_probe_cuda.launches
    if launches != sum(out["launches"].values()) or min(out["launches"].values()) <= 0:
        raise AssertionError(f"the uint16 probe's run launched P16 {out['launches']}")
    if not out["bit_equal_low16"]:
        raise AssertionError("the uint16 fixpoint differs from the uint32 one's low 16 bits")
    log(json.dumps(out))

    # The input's divergence: each board's own sweep count (probe_sweeps),
    # against the warp's largest at 32 and 64 boards a warp; the queue's
    # model at the kernel's tile (about T / SMs boards, a multiple of 8).
    _, sweeps = p16.probe_sweeps(cand32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = -(-batch // sms)  # the kernel's tile: T / SMs boards, rounded up to 8
    tile = -(-tile // 8) * 8
    model = {f"{w} bits": queue_model(sweeps.cpu().numpy(), tile, 128, per_lane)
             for w, per_lane in ((32, 1), (16, 2))}
    log(f"[15] P16 input: {int(sweeps.sum())} board-sweeps, mean {float(sweeps.float().mean()):.4f}"
        f", {int(sweeps.min())}-{int(sweeps.max())} a board; per-warp divergence (warp-max over "
        f"mean): 32 boards a warp {warp_divergence(sweeps, 32):.4f}, 64 boards a warp "
        f"{warp_divergence(sweeps, 64):.4f}; queue model at tile {tile}, 128 lanes: "
        f"{json.dumps(model)}")

    # Bound: each board read and written once; the sweeps each board's own
    # loop runs, at the operations of a basic-rules sweep; 16-bit lanes
    # counted two to an int32 operation (the kernel's SWAR pairing).
    rows = {}
    for name, dtype in widths.items():
        x = cand32.to(dtype)
        ms = device_ms(lambda c: p16.fixpoint_probe_cuda(c), sizes["reps"], lambda x=x: x,
                       "probe_fixpoint_kernel")
        # Beside the profiler: CUDA events around 20 back-to-back launches,
        # so the wrapper's host work between launches is amortized.
        ev_ms = event_ms(lambda c: [p16.fixpoint_probe_cuda(c) for _ in range(20)],
                         sizes["reps"], lambda x=x: x) / 20
        plain_ms = event_ms(lambda _, x=x: p16.fixpoint_probe_plain(x), 1)
        n_bytes = 2 * x.numel() * x.element_size()
        n_ops = int(sweeps.sum()) * sweep_ops(SUDOKU_9, "basic") / (2 if name == "uint16" else 1)
        bms, by = bound_ms(n_bytes, n_ops)
        log(f"[15] P16 timing {name} T={batch}: {ms:.4f} ms (kernel, profiler), {ev_ms:.4f} "
            f"ms (CUDA events, 20 launches back to back), plain "
            f"{plain_ms:.4f} ms, bound {bms:.6f} ms ({by}); board-sweeps {int(sweeps.sum())}")
        rows[name] = dict(launches=out["launches"][name], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return rows


def pcv_ops(inputs, steps: int) -> float:
    """Integer operations of the cover probe on these inputs: per lane and
    step, the lowest-row scan (2 per word) and the stack write (1 per
    word); per row taken, one OR per word for each of its columns, 3 per
    word to clear and keep, 8 meta increments; then the column counts
    (AND, popcount and add per column and word)."""
    import torch

    from distributed_sudoku_solver_tpu_torch.probes import cover_kernel as pcv

    inc, packed = inputs[0], inputs[1]
    w, t = packed.shape
    cols = (inc != 0).sum(1)
    shifts = torch.arange(32, device=packed.device)[None, :, None]
    ops = 0
    for k in range(steps):
        words = pcv.cover_probe_plain(*inputs, k)[1]
        bits = ((words.to(torch.int64) & 0xFFFFFFFF)[:, None, :] >> shifts & 1).reshape(32 * w, t)
        taken = bits.any(0)
        first = bits.to(torch.int8).argmax(0)
        ops += t * 3 * w + int(taken.sum()) * (3 * w + 8) + int(cols[first][taken].sum()) * w
    return ops + inc.shape[1] * w * 3 * t


def phase_pcv(sizes, dev):
    """PCV against its plain version, then the cover probe's own run (its
    launches counted from zero; it checks the pinned checksum); then its
    device time and an empty launch's, each with the L2 cache warm and
    flushed before every launch."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops import cuda_build
    from distributed_sudoku_solver_tpu_torch.probes import cover_kernel as pcv

    inputs = [x.to(dev) for x in pcv.probe_inputs()]
    err = 0
    for steps in (pcv.STEPS, 0, 1, 7):
        got = pcv.cover_probe_cuda(*inputs, steps)
        want = pcv.cover_probe_plain(*inputs, steps)
        torch.cuda.synchronize()
        e = max(max_abs_err(a, b) for a, b in zip(got, want))
        log(f"[16] PCV steps={steps}: checksum {pcv.checksum(got[1])} max_abs_err {e}")
        if e:
            raise AssertionError(f"PCV disagrees with its plain version at {steps} steps")
        err = max(err, e)

    pcv.cover_probe_cuda.launches = 0
    out = pcv.run_probe(dev)
    launches = pcv.cover_probe_cuda.launches
    if launches <= 0:
        raise AssertionError("the cover probe's run launched PCV no time")
    log(json.dumps(out))

    # The kernel alone, through its C entry point: the wrapper's 0/1 check
    # of the incidence runs kernels that would bring it back into L2.  A
    # flush rewrites 128 MB (the L2 holds 50 MB) with a bitwise-not kernel,
    # which the readings leave out by name.
    fn = pcv._lib()
    outs = pcv.cover_probe_cuda(*inputs)
    w, c, t, s = inputs[1].shape[0], inputs[0].shape[1], inputs[1].shape[1], inputs[3].shape[0]

    def kernel(_=None):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(fn(*(x.data_ptr() for x in (*inputs, *outs)), w, c, t, s, pcv.STEPS,
                            stream), "dsst_probe_cover")

    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    one = torch.empty(1, dtype=torch.int32, device=dev)
    readings = {}
    for flushed in (False, True):
        pre = flush_buf.bitwise_not_ if flushed else (lambda: None)
        readings[flushed] = (
            device_ms(lambda _: (pre(), kernel()), sizes["reps"], lambda: None,
                      "probe_cover_kernel"),
            device_ms(lambda _: (pre(), one.fill_(1)), sizes["reps"], lambda: None,
                      "FillFunctor"))
    ms = readings[False][0]
    plain_ms = event_ms(lambda _: pcv.cover_probe_plain(*inputs), sizes["reps"])
    n_bytes = sum(x.numel() * x.element_size() for x in (*inputs, *outs))
    bms, by = bound_ms(n_bytes, pcv_ops(inputs, pcv.STEPS))
    log(f"[16] PCV timing: {ms:.4f} ms with L2 warm, {readings[True][0]:.4f} ms with L2 flushed "
        f"before each launch (kernel, profiler), plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
        f"({by})")
    # PCV's bound lies below any kernel's device time: the attainable floor
    # is an empty launch, here a one-word fill of 1 (a kernel; a fill of 0
    # may become a memset), read the same two ways.
    log(f"[16] an empty launch (a one-word fill): {readings[False][1]:.4f} ms with L2 warm, "
        f"{readings[True][1]:.4f} ms flushed (device time, profiler), PCV's attainable floor")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by)


# -- phase 17: the serving stack over HTTP -------------------------------------


def _http(port: int, path: str, body=None, timeout: float = 600.0):
    """One request to a local node: ``(status, headers, body)``, the body
    parsed as JSON unless the response is text."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, headers, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, dict(e.headers), e.read()
    text = raw.decode()
    return status, headers, (json.loads(text) if headers.get("Content-Type", "").startswith(
        "application/json") else text)


def _post_all(port, boards, threads: int, path: str = "/solve", retry_429: bool = True):
    """POST every board from ``threads`` client threads at once, to
    ``port`` (or to ``port[i]`` for board ``i`` when ``port`` is a list).
    With ``retry_429`` a client sleeps the answer's Retry-After and tries
    again.  Returns per board ``(status, headers, body, latency_ms, tries)``
    and the wall of the whole run."""
    from concurrent.futures import ThreadPoolExecutor

    ports = port if isinstance(port, (list, tuple)) else [port] * len(boards)

    def one(i):
        t0 = time.perf_counter()
        tries = 0
        while True:
            tries += 1
            out = _http(ports[i], path, {"sudoku": boards[i].tolist()})
            if out[0] != 429 or not retry_429:
                return (*out, (time.perf_counter() - t0) * 1e3, tries)
            time.sleep(float(out[1]["Retry-After"]))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        results = list(pool.map(one, range(len(boards))))
    return results, time.perf_counter() - t0


def _route_line(route: str, results, wall_s: float, tag: str = "[17]") -> dict:
    import numpy as np

    lat = np.asarray([r[3] for r in results], dtype=np.float64)
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    row = dict(route=route, requests=len(results), requests_per_s=len(results) / wall_s,
               p50_ms=float(p50), p95_ms=float(p95), p99_ms=float(p99))
    log(f"{tag} route {route}: {row['requests']} requests in {wall_s:.3f} s, "
        f"{row['requests_per_s']:.1f} requests/s, p50 {p50:.3f} / p95 {p95:.3f} / "
        f"p99 {p99:.3f} ms")
    return row


def _check_answers(boards, results, geom_of, what: str) -> None:
    """Every 201 a valid solution keeping its givens; no 422 (every board
    here is satisfiable); nothing else but 429."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution

    for i, (board, (status, _, body, _, _)) in enumerate(zip(boards, results)):
        if status == 201:
            sol = np.asarray(body["solution"])
            if not is_valid_solution(sol, geom_of(board)) or not np.array_equal(
                    sol[board > 0], board[board > 0]):
                raise AssertionError(f"{what} #{i}: invalid solution or lost givens")
        elif status != 429:
            raise AssertionError(f"{what} #{i}: status {status} {body}")


def _check_verdicts(boards, results, cfg, dev, what: str) -> None:
    """Each answered verdict against the port's solve_batch on the same
    boards and config (verdicts do not depend on the batch); the solution
    itself against the oracle's only where the board has one (HARD_9)."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.models.geometry import geometry_for_size
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    by_n: dict = {}
    for i, b in enumerate(boards):
        by_n.setdefault(b.shape[0], []).append(i)
    for n, idx in by_n.items():
        res = solve_batch(np.stack([boards[i] for i in idx]), geometry_for_size(n), cfg,
                          device=dev)
        solved, unsat = res.solved.cpu().numpy(), res.unsat.cpu().numpy()
        for k, i in enumerate(idx):
            status = results[i][0]
            if status == 429:
                continue
            if (status == 201) != bool(solved[k]) or (status == 422) != bool(unsat[k]):
                raise AssertionError(f"{what} #{i}: status {status} against solve_batch's "
                                     f"solved {solved[k]} unsat {unsat[k]}")
    hard = [h.tolist() for h in HARD_9]
    for b, r in zip(boards, results):
        if b.tolist() in hard and r[0] == 201:
            want = hard9_solutions()[hard.index(b.tolist())]
            if not np.array_equal(np.asarray(r[2]["solution"]), want):
                raise AssertionError(f"{what}: a HARD_9 solution differs from the oracle's")


def _syncs_during(fn):
    """``(fn(), host syncs during it)`` across every thread of the process
    (torch's sync debug mode is process-wide)."""
    counts: dict = {}
    out = _count_syncs(fn, counts, "all")
    return out, counts.get("all", 0)


def chunk_syncs(dev, turns=("fused", "composite", "composite", "fused"), chunks=8) -> dict:
    """Host syncs and host wall per status chunk of the two status advances
    the engine and the resident flight drive (``ops.cuda_step.
    advance_frontier_fused_status``, ``utils.checkpoint.
    advance_frontier_status``), at a static flight's shape: 128 carved
    26-clue boards on 128 lanes, 64 stack slots, chunks of 64 steps, each
    chunk's status fetched once.  The boards are enumerated (``count_all``,
    the ``POST /solve`` route's), so every chunk of the run has live
    lanes.  Runs against the checkout that holds this copy of
    the script, so a copy beside a parent's package measures the parent."""
    from dataclasses import replace

    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import advance_frontier_fused_status
    from distributed_sudoku_solver_tpu_torch.ops.frontier import STATUS_LIVE_SUM, SolverConfig
    from distributed_sudoku_solver_tpu_torch.utils.checkpoint import (
        advance_frontier_status,
        start_frontier,
    )

    grids = torch.from_numpy(make_corpus(SUDOKU_9, 128, seed=7, n_clues=26)).to(dev)
    cfg = SolverConfig(lanes=128, stack_slots=64, count_all=True)
    impls = {"fused": (advance_frontier_fused_status, replace(cfg, step_impl="fused")),
             "composite": (advance_frontier_status, cfg)}

    def run(impl, counts=None):
        advance, cfg = impls[impl]
        state = start_frontier(grids, SUDOKU_9, cfg)
        torch.cuda.synchronize()
        walls = []
        for k in range(chunks):
            t0 = time.perf_counter()
            state, status = _count_syncs(lambda: advance(state, 64, SUDOKU_9, cfg), counts, impl)
            status = _count_syncs(lambda: status.cpu(), counts, impl)
            walls.append((time.perf_counter() - t0) * 1e3)
            if int(status[STATUS_LIVE_SUM]) == 0:
                raise AssertionError(f"[chunk-syncs] {impl}: chunk {k} ran with no live lane")
        return walls, int(status[0])

    out = {}
    for impl in impls:
        run(impl)  # warm-up, K2's load included
    for impl in turns:
        counts = {}
        walls, steps = run(impl, counts)
        row = out.setdefault(impl, {"syncs_per_chunk": [], "chunk_ms_p50": [], "steps": steps})
        row["syncs_per_chunk"].append(counts.get(impl, 0) / chunks)
        row["chunk_ms_p50"].append(float(np.median(walls)))
    log(f"[chunk-syncs] {REPO}: {json.dumps(out)}")
    return out


def _zero_breakers(m: dict) -> None:
    """The fallbacks that could hide a failing K2 must not have fired."""
    fa = m["faults"]
    trips = {
        "fused_downgrades": m["fused_downgrades"],
        "fault_downgrades_fused": fa["downgrades"]["fused_to_composite"],
        "fault_lane_halvings": fa["downgrades"]["lanes_halved"],
    }
    for g, r in m.get("resident", {}).items():
        b = r["faults"]["breaker"]
        trips[f"resident {g} breaker"] = b["transitions"] + (b["state"] != "closed")
        trips[f"resident {g} rebuilds"] = r["faults"]["rebuilds"]
    for g, r in m.get("megastep", {}).items():
        b = r["breaker"]
        trips[f"megastep {g} breaker"] = b["transitions"] + (b["state"] != "closed")
        trips[f"megastep {g} degraded"] = sum(r["degraded"].values())
    if any(trips.values()):
        raise AssertionError(f"a fallback fired on the fused node: {trips}")


def phase_serving(corpus, minrem_nodes, device, sizes, dev):
    """The serving stack at the CLI's default 9x9 deployment, over HTTP:
    node F (fused, K2: resident, latency, count_all, solve_batch), then
    node C (composite, K1: static flights) against the default config."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import (
        SUDOKU_9,
        SUDOKU_16,
        geometry_for_size,
    )
    from distributed_sudoku_solver_tpu_torch.obs import promck, trace
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.serving import engine as engine_mod
    from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode
    from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig
    from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig
    from distributed_sudoku_solver_tpu_torch.utils.oracle import count_solutions, is_valid_solution
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle, to_line

    geom_of = lambda b: geometry_for_size(b.shape[0])  # noqa: E731
    # host_fetch wrapped for the phase: every tag counted.
    fetches: dict = {}
    fetch_lock = threading.Lock()
    real_fetch = engine_mod.host_fetch

    def counting_fetch(x, floor_s=0.0, tag="status"):
        with fetch_lock:  # the loop and handler threads both fetch
            fetches[tag] = fetches.get(tag, 0) + 1
        return real_fetch(x, floor_s=floor_s, tag=tag)

    engine_mod.host_fetch = counting_fetch
    routes, syncs = [], {}
    hard9 = [np.asarray(h, np.int32) for h in HARD_9]
    order = np.argsort(-minrem_nodes[len(HARD_9):]) + len(HARD_9)
    try:
        # -- node F: SolverConfig(step_impl="fused"), the CLI's serving shape.
        cfg_f = SolverConfig(step_impl="fused")
        eng = SolverEngine(config=cfg_f, max_batch=256, chunk_steps=64,
                           resident=ResidentConfig(), megastep=MegastepConfig(),
                           device=dev).start()
        api = ApiServer(StandaloneNode(eng, address="127.0.0.1:f"), host="127.0.0.1",
                        port=0, solve_timeout_s=600).start()
        try:
            torch.cuda.synchronize()
            cuda_step.fused_rounds_cuda.launches = 0
            built = cuda_step._GRAPHS.built
            fetches.clear()
            b16 = [make_puzzle(SUDOKU_16, 100 + i, unique=False).astype(np.int32)
                   for i in range(16)]
            n_mass = sizes["serving_mass"] - len(hard9) - len(b16)
            mass = [corpus[len(HARD_9) + i] for i in range(n_mass)] + hard9 + b16
            mass = [mass[i] for i in np.random.default_rng(17).permutation(len(mass))]
            res, wall = _post_all(api.port, mass, threads=sizes["serving_clients"])
            _check_answers(mass, res, geom_of, "resident")
            if any(r[0] != 201 for r in res):
                raise AssertionError("a resident request was not answered 201 after retries")
            routes.append(_route_line("resident", res, wall))
            retried = sum(r[4] > 1 for r in res)
            burst = [corpus[i] for i in order[: sizes["serving_burst"]]]
            bres, bwall = _post_all(api.port, burst, threads=len(burst), retry_429=False)
            _check_answers(burst, bres, geom_of, "burst")
            n429 = [r for r in bres if r[0] == 429]
            if not n429 or any(int(r[1]["Retry-After"]) < 1 or r[2]["retry_after_s"] <= 0
                               for r in n429):
                raise AssertionError(f"the {len(burst)}-request burst drew {len(n429)} 429s "
                                     f"with Retry-After")
            log(f"[17] burst: {len(burst)} requests at once, {len(n429)} answered 429 with "
                f"Retry-After, {sum(r[0] == 201 for r in bres)} 201, {bwall:.3f} s; "
                f"{retried} of the resident route's requests were retried after a 429")
            lat_boards = hard9 + [corpus[i] for i in order[:5]]
            lres, lwall = _post_all(api.port, lat_boards, threads=1, path="/solve?latency=1")
            _check_answers(lat_boards, lres, geom_of, "latency")
            routes.append(_route_line("latency", lres, lwall))
            sol0 = hard9_solutions()[0]
            multi = np.where(np.isin(sol0, (1, 2)), 0, sol0).astype(np.int32)
            want = count_solutions(multi, SUDOKU_9, limit=10_000)
            st, _, body = _http(api.port, "/solve", {"sudoku": multi.tolist(),
                                                     "count_all": True})
            if st != 200 or body["count"] != want or not body["complete"] or \
                    not is_valid_solution(np.asarray(body["solution"])):
                raise AssertionError(f"count_all: {st} {body} against the oracle's {want}")
            log(f"[17] count_all: {body['count']} solutions (oracle {want}), complete, "
                f"{body['duration'] * 1e3:.3f} ms")
            bulk = corpus[len(HARD_9):len(HARD_9) + sizes["serving_bulk"]]
            t0 = time.perf_counter()
            st, _, body = _http(api.port, "/solve_batch",
                                {"lines": [to_line(b) for b in bulk], "size": 9})
            bwall_s = time.perf_counter() - t0
            if st != 200 or body["solved"] != len(bulk) or body["unsat"]:
                raise AssertionError(f"solve_batch: {st}, solved {body.get('solved')}")
            for b, line in zip(bulk, body["solutions"]):
                sol = np.asarray([int(c, 36) for c in line]).reshape(9, 9)
                if not is_valid_solution(sol) or not np.array_equal(sol[b > 0], b[b > 0]):
                    raise AssertionError("solve_batch: an invalid solution")
            routes.append(_route_line("solve_batch", [(st, None, None, bwall_s * 1e3, 1)],
                                      bwall_s))
            log(f"[17] solve_batch: {len(bulk)} boards, {len(bulk) / bwall_s:.0f} boards/s")
            torch.cuda.synchronize()
            launches_f = cuda_step.fused_rounds_cuda.launches
            m = eng.metrics()
            rflights = [rf for rf in eng._resident_flights()]
            mflights = [mf for mf in eng._megastep_flights()]
            want_status = (eng.chunk_wall.snapshot()["total"]
                           + sum(rf.chunks for rf in rflights)
                           + sum(mf.flights for mf in mflights))
            log(f"[17] node F host_fetch by tag {json.dumps(fetches)}; static chunks "
                f"{eng.chunk_wall.snapshot()['total']}, resident chunks "
                f"{sum(rf.chunks for rf in rflights)}, megastep flights "
                f"{sum(mf.flights for mf in mflights)}")
            if fetches.get("status", 0) != want_status:
                raise AssertionError(f"status fetches {fetches.get('status')} != one per "
                                     f"chunk and per megastep flight ({want_status})")
            if launches_f <= 0:
                raise AssertionError("node F launched K2 no time")
            _zero_breakers(m)
            for path in ("/stats", "/metrics", "/status"):
                st, _, body = _http(api.port, path)
                if st != 200 or not isinstance(body, dict):
                    raise AssertionError(f"GET {path}: {st}")
            st, _, text = _http(api.port, "/metrics?format=prometheus")
            errors = promck.check_text(text)
            if st != 200 or errors:
                raise AssertionError(f"prometheus exposition: {st} {errors[:5]}")
            with trace.installed(trace.TraceRecorder(ring=4096)):
                st, _, _ = _http(api.port, "/solve", {"sudoku": hard9[1].tolist(),
                                                      "uuid": "smoke-trace"})
                st2, _, body = _http(api.port, "/trace/smoke-trace?analyze=1")
            if st != 201 or st2 != 200 or not body.get("analysis"):
                raise AssertionError(f"trace analyze: {st} {st2}")
            for name, r in m.get("resident", {}).items():
                log(f"[17] resident {name}: chunks {r['chunks']}, admitted {r['admitted']}, "
                    f"rejected {r['rejected']}, status-sync wall {r.get('chunk_wall_ms')}, "
                    f"dispatch wall {r.get('dispatch_wall_ms')}, event wall "
                    f"{r.get('event_wall_ms')}, admission wait {r.get('admission_wait_ms')}")
            for name, r in m.get("megastep", {}).items():
                log(f"[17] megastep {name}: flights {r['flights']}, chunks per flight "
                    f"{r.get('chunks_per_flight')}, flight wall {r.get('flight_wall_ms')}")
            log(f"[17] node F engine: static chunks {eng.chunk_wall.snapshot()['total']}, "
                f"dispatch wall {m.get('dispatch_wall_ms')}, sync wall "
                f"{m.get('sync_wall_ms')}; K2 launches {launches_f}; fused-loop graphs "
                f"captured {cuda_step._GRAPHS.built - built}, kept {len(cuda_step._GRAPHS)} "
                f"(bound {cuda_step._GRAPHS.size}); fallbacks all 0; "
                f"prometheus clean; /trace analyze served")
            # Host syncs per chunk, one route at a time; their answers are
            # checked as the routes' own are.
            before = sum(rf.chunks for rf in rflights)
            (sync_res, _), n = _syncs_during(lambda: _post_all(api.port, mass[:64], threads=16))
            syncs["resident_per_chunk"] = n / max(1, sum(rf.chunks for rf in rflights) - before)
            _check_answers(mass[:64], sync_res, geom_of, "resident (syncs)")
            before = sum(mf.flights for mf in mflights)
            (sync_lat, _), n = _syncs_during(lambda: _post_all(api.port, hard9, threads=1,
                                                               path="/solve?latency=1"))
            syncs["latency_per_flight"] = n / max(1, sum(mf.flights for mf in mflights) - before)
            _check_answers(hard9, sync_lat, geom_of, "latency (syncs)")
            (st, _, body), n = _syncs_during(lambda: _http(api.port, "/solve_batch", {
                "boards": [b.tolist() for b in bulk[:1024]]}))
            syncs["solve_batch_per_call"] = n
            if st != 200 or body["solved"] != 1024 or body["unsat"]:
                raise AssertionError(f"solve_batch (syncs): {st}, solved {body.get('solved')}")
            _zero_breakers(eng.metrics())  # after every request node F served
        finally:
            api.stop()
            eng.stop(timeout=10)
        # The reference verdicts (their K2 launches are not the node's).
        _check_verdicts(mass + burst + lat_boards + mass[:64] + hard9,
                        res + bres + lres + sync_res + sync_lat, cfg_f, dev, "node F")

        # -- node C: composite with K1, static flights only.
        cfg_c = SolverConfig(propagator="pallas")
        eng = SolverEngine(config=cfg_c, max_batch=256, chunk_steps=64, resident=None,
                           device=dev)
        groups = []
        start_flight = eng._start_flight

        def recording_start(geom, cfg, jobs):
            groups.append((geom, list(jobs)))
            return start_flight(geom, cfg, jobs)

        eng._start_flight = recording_start
        eng.start()
        api = ApiServer(StandaloneNode(eng, address="127.0.0.1:c"), host="127.0.0.1",
                        port=0, solve_timeout_s=600).start()
        try:
            static = [corpus[len(HARD_9) + 5000 + i] for i in range(sizes["serving_static"])]
            torch.cuda.synchronize()
            cuda_propagate.propagate_fixpoint_cuda.launches = 0
            fetches.clear()
            sres, swall = _post_all(api.port, static, threads=256, retry_429=False)
            torch.cuda.synchronize()
            launches_c = cuda_propagate.propagate_fixpoint_cuda.launches
            _check_answers(static, sres, geom_of, "static")
            if any(r[0] != 201 for r in sres):
                raise AssertionError("a static-flight request was not answered 201")
            routes.append(_route_line("static", sres, swall))
            if launches_c <= 0:
                raise AssertionError("node C launched K1 no time")
            if fetches.get("status", 0) != eng.chunk_wall.snapshot()["total"]:
                raise AssertionError(f"node C status fetches {fetches.get('status')} != "
                                     f"chunks {eng.chunk_wall.snapshot()['total']}")
            m = eng.metrics()
            log(f"[17] node C: {len(groups)} static flights of {[len(j) for _, j in groups]} "
                f"jobs, chunks {m['chunk_wall_ms']['count']}, dispatch wall "
                f"{m.get('dispatch_wall_ms')}, sync wall {m.get('sync_wall_ms')}; K1 launches "
                f"{launches_c}; host_fetch by tag {json.dumps(fetches)}")
            before = eng.chunk_wall.snapshot()["total"]
            (sync_static, _), n = _syncs_during(lambda: _post_all(
                api.port, static[:32], threads=32, retry_429=False))
            syncs["static_per_chunk"] = n / max(1, eng.chunk_wall.snapshot()["total"] - before)
            _check_answers(static[:32], sync_static, geom_of, "static (syncs)")
            if any(r[0] != 201 for r in sync_static):
                raise AssertionError("a static-flight request (syncs) was not answered 201")
        finally:
            api.stop()
            eng.stop(timeout=10)
        # The same flights, by hand, on an engine with the default config:
        # composite with the plain propagation, bit-identical by contract.
        ref = SolverEngine(config=SolverConfig(), max_batch=256, chunk_steps=64, device=dev)
        checked = 0
        for geom, jobs in groups[: len(groups)]:
            twins = [Job(uuid=f"ref-{j.uuid}", grid=j.grid, geom=geom) for j in jobs]
            ref._start_flight(geom, ref.config, twins)
            fl = ref._flights.pop()
            while not ref._advance_flight(fl):
                pass
            for j, t in zip(jobs, twins):
                if j.solution is None or t.solution is None or not np.array_equal(
                        j.solution, t.solution) or j.nodes != t.nodes or j.solved != t.solved:
                    raise AssertionError(f"static flight {j.uuid}: K1 and the plain "
                                         f"propagation disagree")
                checked += 1
        log(f"[17] node C flights replayed with SolverConfig(): {checked} jobs, solutions "
            f"and node counts bit-identical")
        _check_verdicts(static + static[:32], sres + sync_static, cfg_c, dev, "node C")
    finally:
        engine_mod.host_fetch = real_fetch
    log(f"[17] host syncs (torch sync debug mode): {json.dumps(syncs)}")
    log(f"[17] {device['smi']}")
    log(json.dumps({"serving": {"routes": routes, "syncs": syncs, "card": device["smi"]}}))
    return {"K2": launches_f, "K1": launches_c}


# -- phase 18: the front door and the portfolio over HTTP ----------------------


def _expect_solutions(results, want, what: str) -> None:
    """Every answer 201 with exactly the expected (unique) solution."""
    import numpy as np

    for i, (r, w) in enumerate(zip(results, want)):
        if r[0] != 201 or not np.array_equal(np.asarray(r[2]["solution"]), w):
            raise AssertionError(f"{what} #{i}: status {r[0]}, not the oracle's solution: "
                                 f"{str(r[2])[:200]}")


def phase_frontdoor(corpus, device, sizes, dev) -> dict:
    """Node D: node F of phase 17 plus the front door, behind HTTP.  Unique
    carved boards (pass A), their transforms (pass B, the cache), unsat
    boards and their transforms (422, the negative cache), 16x16 boards
    (uncacheable), portfolio races, the cover race and ``solve_file``.
    Returns K2's launches on node D's traffic and in ``solve_file``."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.obs import promck
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor.canonical import (
        apply_transform,
        canonicalize,
        random_transform,
    )
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import (
        FrontDoorConfig,
        probe_propagate,
    )
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode
    from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig
    from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_cover
    from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig
    from distributed_sudoku_solver_tpu_torch.utils import dataset
    from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native oracle did not build (g++)")
    log(f"[18] native library {native.lib_path().name}: "
        + (f"built in {native.build_seconds:.3f} s in this run (phase 2)"
           if native.build_seconds is not None else "found built"))
    hard9 = [np.asarray(h, np.int32) for h in HARD_9]
    carved, want = _unique_boards(sizes["frontdoor_unique"], 1000)
    boards = carved + hard9
    want = want + [native.solve(b)[0] for b in hard9]
    if any(w is None or native.count_solutions(b, limit=2) != 1 for b, w in zip(hard9, want[len(carved):])):
        raise AssertionError("a HARD_9 board is not a unique puzzle")
    log(f"[18] corpus: {len(carved)} unique carved 9x9 boards (seeds 1000.., clue targets "
        f"22-30) + HARD_9, oracle solutions, in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(18)
    trs = [random_transform(SUDOKU_9, rng) for _ in boards]
    unsat = []
    for b in carved[:sizes["frontdoor_unsat"]]:
        bad = b.copy()
        r = int(np.flatnonzero((bad == 0).any(1) & (bad > 0).any(1))[0])
        c = int(np.flatnonzero(bad[r] == 0)[0])
        bad[r, c] = bad[r][bad[r] > 0][0]  # a given of the same row: a conflict
        unsat.append(bad)
    b16 = [make_puzzle(SUDOKU_16, 200 + i, unique=False).astype(np.int32) for i in range(16)]
    # The front door's two host tiers, one thread, no server: their cost per
    # board on this host (the passes below pay them under 32 clients).
    t1 = time.perf_counter()
    scores = [probe_propagate(b, SUDOKU_9).score for b in carved]
    probe_ms = (time.perf_counter() - t1) * 1e3 / len(carved)
    top5 = [carved[i] for i in np.argsort(scores)[::-1][:5]]
    t1 = time.perf_counter()
    cacheable = sum(canonicalize(b, SUDOKU_9) is not None for b in boards)
    canon_ms = (time.perf_counter() - t1) * 1e3 / len(boards)
    log(f"[18] host cost per 9x9 board, one thread: canonical form {canon_ms:.3f} ms, "
        f"probe {probe_ms:.3f} ms")

    eng = SolverEngine(config=SolverConfig(step_impl="fused"), max_batch=256, chunk_steps=64,
                       resident=ResidentConfig(), megastep=MegastepConfig(),
                       frontdoor=FrontDoorConfig(), device=dev).start()
    api = ApiServer(StandaloneNode(eng, address="127.0.0.1:d"), host="127.0.0.1", port=0,
                    solve_timeout_s=600).start()
    passes, routes = {}, {}
    try:
        if not eng.frontdoor.native_available:
            raise AssertionError("node D's front door sees no native oracle")
        fd = eng.frontdoor
        torch.cuda.synchronize()
        cuda_step.fused_rounds_cuda.launches = 0
        res_a, wall_a = _post_all(api.port, boards, threads=sizes["serving_clients"])
        _expect_solutions(res_a, want, "pass A")
        passes["A"] = len(boards) / wall_a
        cache_before = fd.metrics()["routes"]["cache"]
        moved = [apply_transform(b, tr) for b, tr in zip(boards, trs)]
        res_b, wall_b = _post_all(api.port, moved, threads=sizes["serving_clients"])
        _expect_solutions(res_b, [apply_transform(w, tr) for w, tr in zip(want, trs)], "pass B")
        passes["B"] = len(moved) / wall_b
        hits_b = fd.metrics()["routes"]["cache"] - cache_before
        if hits_b < cacheable:
            raise AssertionError(f"pass B: {hits_b} cache answers < {cacheable} cacheable "
                                 f"pass-A verdicts")
        log(f"[18] pass A: {len(boards)} requests, {passes['A']:.1f} requests/s; pass B "
            f"(each board under one random transform): {passes['B']:.1f} requests/s, "
            f"{hits_b} answered from the cache (>= {cacheable} cacheable)")
        neg_before = fd.cache.metrics()["negative_hits"]
        for what, group in (("unsat", unsat),
                            ("unsat transformed", [apply_transform(b, trs[i])
                                                   for i, b in enumerate(unsat)])):
            res_u, _ = _post_all(api.port, group, threads=8)
            if any(r[0] != 422 for r in res_u):
                raise AssertionError(f"{what}: {[r[0] for r in res_u]} (want 422 each)")
        neg = fd.cache.metrics()["negative_hits"] - neg_before
        if neg < len(unsat):
            raise AssertionError(f"negative cache answered {neg} < {len(unsat)} repeats")
        unc_before = fd.metrics()["uncacheable"]
        res_16, _ = _post_all(api.port, b16, threads=16)
        for b, r in zip(b16, res_16):
            sol = np.asarray(r[2].get("solution", []))
            if r[0] != 201 or not is_valid_solution(sol, SUDOKU_16) or not np.array_equal(
                    sol[b > 0], b[b > 0]):
                raise AssertionError(f"16x16: status {r[0]}, invalid answer")
        if fd.metrics()["uncacheable"] - unc_before != len(b16):
            raise AssertionError("16x16 boards were not counted uncacheable")
        log(f"[18] unsat: {len(unsat)} boards 422, their transforms 422 from the negative "
            f"cache ({neg} negative hits); 16x16: {len(b16)} answered, uncacheable")
        folio = hard9 + top5
        folio_want = [native.solve(b)[0] for b in folio]
        walls, winners = [], []
        for b, w in zip(folio, folio_want):
            t1 = time.perf_counter()
            st, _, body = _http(api.port, "/solve", {"sudoku": b.tolist(), "portfolio": True})
            walls.append((time.perf_counter() - t1) * 1e3)
            if st != 201 or not np.array_equal(np.asarray(body["solution"]), w):
                raise AssertionError(f"portfolio: status {st}, not the oracle's solution")
            winners.append(body["strategy"])
        log(f"[18] portfolio: {len(folio)} races (HARD_9 + the 5 highest probe scores "
            f"{sorted(scores)[::-1][:5]}), walls ms {[round(x, 3) for x in walls]}, winning "
            f"strategies {winners}")
        torch.cuda.synchronize()
        launches_d = cuda_step.fused_rounds_cuda.launches
        m = eng.metrics()
        _zero_breakers(m)
        fdm = m["frontdoor"]
        if min(fdm["routes"].values()) <= 0:
            raise AssertionError(f"a front-door route went unused: {fdm['routes']}")
        if launches_d <= 0:
            raise AssertionError("node D launched K2 no time")
        st, _, text = _http(api.port, "/metrics?format=prometheus")
        errors = promck.check_text(text)
        if st != 200 or errors:
            raise AssertionError(f"prometheus exposition: {st} {errors[:5]}")
        for name, r in m.get("resident", {}).items():
            log(f"[18] resident {name}: chunks {r['chunks']}, admitted {r['admitted']}, "
                f"rejected {r['rejected']}, dispatch wall {r.get('dispatch_wall_ms')}, "
                f"admission wait {r.get('admission_wait_ms')}")
        for name in ("cache", "propagation", "native", "device"):
            h = eng.hist[f"frontdoor_{name}_ms"]
            routes[name] = dict(count=fdm["routes"][name], hist_samples=len(h),
                                **{f"p{q}_ms": h.quantile(q / 100) for q in (50, 95, 99)})
            log(f"[18] route {name}: {routes[name]}")
        log(f"[18] node D front door: probe {fdm['probe']}, cache {fdm['cache']}, "
            f"uncacheable {fdm['uncacheable']}, native fallback wins "
            f"{fdm['native_fallback_wins']}; K2 launches {launches_d}; fallbacks all 0; "
            f"prometheus clean")
    finally:
        api.stop()
        eng.stop(timeout=10)

    t1 = time.perf_counter()
    cover = race_cover(nqueens_cover(12), timeout=300.0, device=dev)
    cover_wall = time.perf_counter() - t1
    if cover.count != COVER_COUNTS["nqueens12"] or not cover.complete:
        raise AssertionError(f"cover race: {cover}")
    log(f"[18] cover race n-queens 12: {cover.count} solutions, complete, winner "
        f"{cover.winner}, {cover.nodes} nodes, wall {cover_wall * 1e3:.3f} ms")

    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "boards.txt"), os.path.join(tmp, "solved.txt")
        dataset.save_boards(src, corpus)
        torch.cuda.synchronize()
        cuda_step.fused_rounds_cuda.launches = 0
        t1 = time.perf_counter()
        stats = dataset.solve_file(src, out, SUDOKU_9, device=dev)
        file_wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches_f = cuda_step.fused_rounds_cuda.launches
        sols = dataset.load_boards(out, SUDOKU_9)
    if stats["total"] != len(corpus) or stats["solved"] != len(corpus) or stats["unsat"] or \
            len(sols) != len(corpus):
        raise AssertionError(f"solve_file: {stats}, {len(sols)} lines")
    check_solutions(corpus, sols, np.ones(len(sols), bool), np.zeros(len(sols), bool),
                    "solve_file")
    if launches_f <= 0:
        raise AssertionError("solve_file launched K2 no time")
    log(f"[18] solve_file: {len(corpus)} boards in {file_wall:.3f} s, "
        f"{len(corpus) / file_wall:.0f} boards/s, {stats}; K2 launches {launches_f}")

    node = StandaloneNode()
    try:
        if node.engine.frontdoor is None or node.engine.device.type != "cuda":
            raise AssertionError("StandaloneNode() built no front door on CUDA")
        api = ApiServer(node, host="127.0.0.1", port=0, solve_timeout_s=600).start()
        try:
            res, _ = _post_all(api.port, boards[:2], threads=2)
            _expect_solutions(res, want[:2], "default node")
        finally:
            api.stop()
    finally:
        node.engine.stop(timeout=10)
    log("[18] StandaloneNode(): front door on CUDA, two boards answered")
    log(f"[18] {device['smi']}")
    log(json.dumps({"frontdoor": {
        "requests_per_s": passes, "routes": routes, "host_ms_per_board": {
            "canonical": canon_ms, "probe": probe_ms}, "portfolio_ms": walls,
        "portfolio_winners": winners, "cover_race": {"winner": cover.winner,
                                                     "wall_ms": cover_wall * 1e3},
        "solve_file_boards_per_s": len(corpus) / file_wall, "card": device["smi"]}}))
    return {"K2": launches_d + launches_f}


def _free_ports(k: int) -> list:
    import socket

    socks = []
    try:
        for _ in range(k):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _RingNode:
    """One node of ring R: a process started the way a user starts one,
    ``python -m distributed_sudoku_solver_tpu_torch -p <http> -s <p2p>``,
    its output in a log file."""

    def __init__(self, name: str, node_cmd, http: int, p2p: int, anchor, logdir: str):
        self.name, self.node_cmd, self.http, self.p2p = name, node_cmd, http, p2p
        self.anchor = anchor
        self.log_path = os.path.join(logdir, f"node-{name}.log")
        self.proc = None

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.p2p}"

    def start(self) -> None:
        argv = list(self.node_cmd) + [
            "-p", str(self.http), "-s", str(self.p2p), "--host", "127.0.0.1",
            "--advertise-host", "127.0.0.1"]
        if self.anchor:
            argv += ["-a", f"127.0.0.1:{self.anchor}"]
        with open(self.log_path, "ab") as out:
            self.proc = subprocess.Popen(argv, cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                                         env=dict(os.environ, PYTHONUNBUFFERED="1"))

    def tail(self, n: int = 30) -> str:
        with open(self.log_path, errors="replace") as f:
            return "".join(f.readlines()[-n:])

    def members(self):
        """The members its ``GET /network`` lists, or None while it does not answer."""
        try:
            st, _, body = _http(self.http, "/network", timeout=5)
        except OSError:
            return None
        return sorted(body) if st == 200 else None

    def cluster(self) -> dict:
        st, _, body = _http(self.http, "/metrics", timeout=60)
        if st != 200:
            raise AssertionError(f"node {self.name}: /metrics {st}")
        return body


def _ring_wait(nodes, pred, timeout: float, what: str) -> float:
    """Poll ``pred`` until it holds; the wall it took.  Fails with the
    nodes' log tails if it does not hold in time or a node process died."""
    t0 = time.perf_counter()
    while not pred():
        dead = [n for n in nodes if n.proc is not None and n.proc.poll() is not None]
        if dead or time.perf_counter() - t0 > timeout:
            logs = "\n".join(f"--- node {n.name} ---\n{n.tail()}" for n in nodes)
            raise AssertionError(f"[19] {what}: " + (
                f"node {dead[0].name} exited {dead[0].proc.returncode}" if dead else
                f"not within {timeout:g} s") + f"\n{logs}")
        time.sleep(0.05)
    return time.perf_counter() - t0


_UNIQUE_BOARDS: dict = {}


def _unique_boards(count: int, seed: int):
    """``count`` unique 9x9 boards carved with ``make_puzzle(unique=True)``
    (seeds ``seed``.., clue targets 22-30) and their native-oracle
    solutions, made once per run (phases 18 and 19 share them)."""
    if (count, seed) in _UNIQUE_BOARDS:
        return _UNIQUE_BOARDS[count, seed]
    import numpy as np

    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import make_puzzle

    boards = [make_puzzle(SUDOKU_9, seed + i, n_clues=22 + i % 9).astype(np.int32)
              for i in range(count)]
    want = [native.solve(b)[0] for b in boards]
    if any(w is None or native.count_solutions(b, limit=2) != 1 for b, w in zip(boards, want)):
        raise AssertionError("a carved board is not a unique puzzle")
    _UNIQUE_BOARDS[count, seed] = boards, want
    return boards, want


def _cluster_counter(nodes, key: str) -> dict:
    return {n.name: n.cluster()["cluster"][key] for n in nodes}


def phase_ring(corpus, device, sizes, node_cmd=None) -> dict:
    """Ring R: three node processes of the CLI's default deployment on one
    card, joined through A, serving passes A (placement), B (the DHT-routed
    cache), a crash of C with re-execution and C's rejoin, ``/solve_batch``
    on every node, the federated ``/metrics`` and a SIGTERM drain."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor.canonical import (
        apply_transform,
        canonicalize,
        random_transform,
    )
    from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, to_line

    node_cmd = node_cmd or [sys.executable, "-m", "distributed_sudoku_solver_tpu_torch"]
    heartbeat_s, fail_factor = 1.0, 3.0  # the CLI's defaults (ClusterConfig)
    clients = sizes["serving_clients"]
    t0 = time.perf_counter()
    carved, want_c = _unique_boards(sizes["cluster_unique"], 1000)
    hard9 = [np.asarray(h, np.int32) for h in HARD_9]
    boards = carved + hard9
    want = want_c + list(hard9_solutions())
    crash, want_crash = _unique_boards(sizes["cluster_crash"], 5000)
    cacheable = sum(canonicalize(b, SUDOKU_9) is not None for b in boards)
    log(f"[19] corpus: {len(carved)} unique boards (seeds 1000..) + HARD_9, {cacheable} "
        f"cacheable; crash corpus {len(crash)} unique boards (seeds 5000..); "
        f"{time.perf_counter() - t0:.2f} s")
    http_a, p2p_a, http_b, p2p_b, http_c, p2p_c = _free_ports(6)
    logdir = tempfile.mkdtemp(prefix="dsst-ring-")
    a = _RingNode("A", node_cmd, http_a, p2p_a, None, logdir)
    b = _RingNode("B", node_cmd, http_b, p2p_b, p2p_a, logdir)
    c = _RingNode("C", node_cmd, http_c, p2p_c, p2p_a, logdir)
    nodes = [a, b, c]
    out: dict = {}
    try:
        t1 = time.perf_counter()
        a.start()
        _ring_wait(nodes, lambda: a.members() == [a.addr], 300, "A never answered")
        b.start()
        c.start()
        three = sorted(n.addr for n in nodes)
        _ring_wait(nodes, lambda: all(n.members() == three for n in nodes), 300,
                   "the ring never listed 3 members")
        out["ring_up_s"] = time.perf_counter() - t1
        log(f"[19] ring R up: A {a.addr}, B {b.addr}, C {c.addr} (http {http_a}, {http_b}, "
            f"{http_c}); every GET /network lists 3 members after {out['ring_up_s']:.2f} s")

        # Pass A: round-robin over the three HTTP ports; placement spreads it.
        runs0 = _cluster_counter(nodes, "tasks_run")
        ports = [nodes[i % 3].http for i in range(len(boards))]
        res, wall = _post_all(ports, boards, threads=clients)
        _expect_solutions(res, want, "[19] pass A")
        out["pass_A"] = _route_line("pass A", res, wall, tag="[19]")
        runs = _cluster_counter(nodes, "tasks_run")
        served = {k: runs[k] - runs0[k] for k in runs}
        if min(served.values()) <= 0:
            raise AssertionError(f"[19] pass A: a node ran no job another node accepted: {served}")
        log(f"[19] pass A: TASKs from peers run per node {served}")

        # Pass B: each board under one seeded transform, to the next node.
        rng = np.random.default_rng(19)
        trs = [random_transform(SUDOKU_9, rng) for _ in boards]
        moved = [apply_transform(x, tr) for x, tr in zip(boards, trs)]
        cache0 = {n.name: n.cluster()["frontdoor"]["routes"]["cache"] for n in nodes}
        aff0 = {n.name: n.cluster()["dht"]["affinity"]["routed"] for n in nodes}
        ports = [nodes[(i + 1) % 3].http for i in range(len(moved))]
        res, wall = _post_all(ports, moved, threads=clients)
        _expect_solutions(res, [apply_transform(w, tr) for w, tr in zip(want, trs)], "[19] pass B")
        out["pass_B"] = _route_line("pass B", res, wall, tag="[19]")
        cache = {n.name: n.cluster()["frontdoor"]["routes"]["cache"] - cache0[n.name]
                 for n in nodes}
        aff = {n.name: n.cluster()["dht"]["affinity"]["routed"] - aff0[n.name] for n in nodes}
        dht = {}
        for n in nodes:
            st, _, body = _http(n.http, "/network?scope=dht")
            if st != 200:
                raise AssertionError(f"[19] node {n.name}: /network?scope=dht {st}")
            dht[n.name] = {k: body["cluster_cache"][k] for k in (
                "entries", "lookups", "local_hits", "remote_hits", "misses", "puts_sent",
                "gets_served")}
            if sorted(body["members"]) != three or any(
                    m["state"] != "alive" for m in body["members"].values()):
                raise AssertionError(f"[19] node {n.name}: gossip view {body['members']}")
        if sum(cache.values()) < cacheable:
            raise AssertionError(f"[19] pass B: {sum(cache.values())} cache answers on the "
                                 f"digest owners < {cacheable} cacheable boards")
        out["dht"] = {"cache_answers": cache, "affinity_routed": aff, "shards": dht}
        log(f"[19] pass B: cache answers per node {cache} (>= {cacheable} cacheable), affinity-"
            f"routed submits {aff}; DHT shards {json.dumps(dht)}")

        # Crash: C is SIGKILLed with a job of A's or B's in flight.
        re0 = _cluster_counter([a, b], "reexecuted")
        rs0 = _cluster_counter([a, b], "resumed")
        box: dict = {}
        ports = [(a, b)[i % 2].http for i in range(len(crash))]
        pump = threading.Thread(
            target=lambda: box.update(zip(("res", "wall"), _post_all(ports, crash, clients))),
            daemon=True)
        t_pass = time.perf_counter()
        pump.start()
        t_kill = None
        while pump.is_alive():
            try:
                running = c.cluster()["cluster"]["execs_running"]
                if running >= 1 and pump.is_alive():
                    c.proc.kill()
                    t_kill = time.perf_counter()
                    break
            except OSError:
                pass
            time.sleep(0.002)
        if t_kill is None:
            raise AssertionError("[19] crash: C never held a job in flight")
        c.proc.wait(60)
        two = sorted([a.addr, b.addr])
        detect = _ring_wait([a, b], lambda: a.members() == two and b.members() == two,
                            60, "A and B never dropped C")
        pump.join(900)
        if pump.is_alive():
            raise AssertionError("[19] crash: clients still waiting after 900 s")
        _expect_solutions(box["res"], want_crash, "[19] crash pass")
        out["crash"] = _route_line("crash", box["res"], box["wall"], tag="[19]")
        reexec = {k: v - re0[k] for k, v in _cluster_counter([a, b], "reexecuted").items()}
        resumed = {k: v - rs0[k] for k, v in _cluster_counter([a, b], "resumed").items()}
        if sum(reexec.values()) <= 0:
            raise AssertionError("[19] crash: no job was re-executed or resumed")
        bound = fail_factor * heartbeat_s + 5.0
        if detect > bound:
            raise AssertionError(f"[19] crash: A and B dropped C after {detect:.2f} s > {bound} s")
        t1 = time.perf_counter()
        c.start()
        _ring_wait(nodes, lambda: all(n.members() == three for n in nodes), 300,
                   "C never rejoined")
        rejoin = time.perf_counter() - t1
        out["crash"].update(detect_s=detect, rejoin_s=rejoin, reexecuted=reexec, resumed=resumed)
        log(f"[19] crash: C killed {t_kill - t_pass:.3f} s into the pass with {running} "
            f"job(s) of A's or B's running there; the pass ended {box['wall']:.3f} s in")
        log(f"[19] crash: A and B list 2 members after "
            f"{detect:.3f} s (bound {bound:g} s); {len(crash)} requests answered, none lost, "
            f"no 5xx; re-executed {reexec}, of which resumed from a snapshot {resumed}; C "
            f"restarted on its ports and all three list 3 members after {rejoin:.3f} s")

        # K2 on every node: /solve_batch runs solve_bulk (BulkConfig(): fused).
        bulk = corpus[:sizes["cluster_bulk"]]
        out["solve_batch_boards_per_s"] = {}
        for n in nodes:
            t1 = time.perf_counter()
            st, _, body = _http(n.http, "/solve_batch",
                                {"lines": [to_line(x) for x in bulk], "size": 9})
            wall = time.perf_counter() - t1
            if st != 200 or body["solved"] != len(bulk) or body["unsat"]:
                raise AssertionError(f"[19] node {n.name} solve_batch: {st} {str(body)[:300]}")
            for x, line in zip(bulk, body["solutions"]):
                sol = np.asarray([int(ch, 36) for ch in line]).reshape(9, 9)
                if not is_valid_solution(sol) or not np.array_equal(sol[x > 0], x[x > 0]):
                    raise AssertionError(f"[19] node {n.name} solve_batch: an invalid solution")
            out["solve_batch_boards_per_s"][n.name] = len(bulk) / wall
        log(f"[19] /solve_batch of {len(bulk)} boards on each node, boards/s "
            f"{out['solve_batch_boards_per_s']}")

        # Federation: the rollup is the sum of the per-node bodies.
        st, _, cm = _http(a.http, "/metrics?scope=cluster")
        per = cm["nodes"]
        if st != 200 or len(per) != 3 or any(v["unreachable"] for v in per.values()):
            raise AssertionError(f"[19] /metrics?scope=cluster: {st}, nodes {list(per)}")
        jobs = sum(v["metrics"]["jobs_done"] for v in per.values())
        if cm["rollup"]["counters"]["jobs_done"] != jobs:
            raise AssertionError(f"[19] rollup jobs_done {cm['rollup']['counters']} != {jobs}")
        log(f"[19] /metrics?scope=cluster: 3 members reachable, rollup jobs_done {jobs} = "
            f"the per-node sum")

        # Stop: SIGTERM drains each node, which exits 0.
        for n in nodes:
            n.proc.terminate()
        for n in nodes:
            rc = n.proc.wait(120)
            if rc != 0 or "drain: {'state': 'drained'" not in n.tail(200):
                raise AssertionError(f"[19] node {n.name} stop: exit {rc}\n{n.tail()}")
        log("[19] SIGTERM: each node printed its drain line and exited 0")
    finally:
        for n in nodes:
            if n.proc is not None and n.proc.poll() is None:
                n.proc.kill()
                n.proc.wait(30)
    return out


def _deep_unsat_board():
    """HARD_9[1] with one consistent-looking wrong clue: its unsat proof is
    a search several chunks long that a ring can share."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    g = np.asarray(HARD_9[1], np.int32).copy()
    g[1, 6] = 8
    return g


def phase_offload(dev, attempts: int = 32, chunk_steps: int = 8) -> dict:
    """(O): two ``ClusterNode``s over TCP on 127.0.0.1 in this process,
    their engines phase 17's node F (fused, K2) without a resident flight,
    so static flights have a shed surface, and with ``chunk_steps`` rounds a
    chunk: the deep unsat board's proof runs 98 rounds, which at node F's
    64 spans two chunks, and a NEEDWORK is served between chunks, after
    the next chunk is enqueued, so it finds the proof's rows only in the
    few boards where it lands inside the first.  The board goes to the
    first node, slowed by a handicap, until the idle second node has asked
    for work and run a shed SUBTASK (at most ``attempts`` boards, one
    after another); every verdict must be the oracle's (unsat)."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch import native
    from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterConfig, ClusterNode
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    board = _deep_unsat_board()
    if native.solve(board)[0] is not None:
        raise AssertionError("(O): the deep board is not unsat")
    ccfg = ClusterConfig(heartbeat_s=0.2, fail_factor=64.0, io_timeout_s=2.0, needwork=True,
                         shed_k=8, progress_interval_s=0.0)

    def node(anchor=None):
        eng = SolverEngine(config=SolverConfig(step_impl="fused"), max_batch=256,
                           chunk_steps=chunk_steps, megastep=MegastepConfig(),
                           device=dev).start()
        return ClusterNode(eng, host="127.0.0.1", port=0, anchor=anchor, config=ccfg,
                           advertise_host="127.0.0.1").start()

    n1 = node()
    n2 = node(n1.addr)
    try:
        t0 = time.perf_counter()
        while len(n1.network) < 2 or len(n2.network) < 2:
            if time.perf_counter() - t0 > 60:
                raise AssertionError("(O): the two nodes never joined")
            time.sleep(0.05)
        for n in (n1, n2):
            w = n.engine.submit(np.asarray(HARD_9[0], np.int32))
            if not w.wait(300) or not w.solved:
                raise AssertionError(f"(O) warm-up: {w.error}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        cuda_step.fused_rounds_cuda.launches = 0
        n1.engine.handicap_s = 0.05
        walls = []
        for k in range(attempts):
            t1 = time.perf_counter()
            job = n1._submit_local(board)
            if not job.wait(300):
                raise AssertionError("(O): the unsat proof never finished")
            if not job.unsat or job.solved or job.error:
                raise AssertionError(f"(O): verdict unsat={job.unsat} solved={job.solved} "
                                     f"error={job.error}, the oracle's is unsat")
            walls.append((time.perf_counter() - t1) * 1e3)
            if n1.subtasks_sent >= 1 and n2.subtasks_run >= 1:
                break
        n1.engine.handicap_s = 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = cuda_step.fused_rounds_cuda.launches
        if n1.subtasks_sent < 1 or n2.subtasks_run < 1:
            raise AssertionError(f"(O): no SUBTASK shed in {attempts} boards (sent "
                                 f"{n1.subtasks_sent}, run {n2.subtasks_run})")
        if dev.type == "cuda" and launches <= 0:
            raise AssertionError("(O): K2 launched no time")
        out = dict(corpus="deep unsat 9x9 (HARD_9[1] with r1c7=8)", chunk_steps=chunk_steps,
                   boards=k + 1,
                   subtasks_sent=n1.subtasks_sent, subtasks_run=n2.subtasks_run,
                   walls_ms=walls, k2_launches=launches)
        log(f"[19] (O) offload: {json.dumps(out)}")
        return out
    finally:
        for n in (n1, n2):
            n.kill()
            n.engine.stop(timeout=10)


def phase_solve_file_cli(corpus, dev) -> dict:
    """(F): ``cli.main(["solve-file", ...])`` on the corpus as lines; every
    output line solved, valid and keeping its givens; K2 launched."""
    import contextlib
    import io

    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch import cli
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.utils import dataset

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "boards.txt"), os.path.join(tmp, "solved.txt")
        dataset.save_boards(src, corpus)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        cuda_step.fused_rounds_cuda.launches = 0
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["solve-file", src, "-o", dst], device=None if dev.type == "cuda" else dev)
        wall = time.perf_counter() - t1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = cuda_step.fused_rounds_cuda.launches
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        sols = dataset.load_boards(dst, SUDOKU_9)
    if stats["total"] != len(corpus) or stats["solved"] != len(corpus) or stats["unsat"] or \
            len(sols) != len(corpus):
        raise AssertionError(f"(F) solve-file: {stats}, {len(sols)} lines")
    check_solutions(corpus, sols, np.ones(len(sols), bool), np.zeros(len(sols), bool),
                    "(F) solve-file")
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("(F) solve-file launched K2 no time")
    out = dict(boards=len(corpus), wall_s=wall, boards_per_s=len(corpus) / wall,
               cli_stats=stats, k2_launches=launches)
    log(f"[19] (F) solve-file through cli.main: {json.dumps(out)}")
    return out


def phase_cluster(corpus, device, sizes, dev, node_cmd=None) -> dict:
    """Phase 19: ring R (three CLI node processes), then, in this process,
    (F) ``solve-file`` through ``cli.main`` and (O) the NEEDWORK offload.
    Returns K2's launches on (F) and (O)."""
    t0 = time.perf_counter()
    ring = phase_ring(corpus, device, sizes, node_cmd)
    f = phase_solve_file_cli(corpus, dev)
    o = phase_offload(dev)
    log(f"[19] {device['smi']}; phase wall {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"cluster": {"ring": ring, "solve_file": f, "offload": o,
                                "card": device["smi"]}}))
    return {"K2": f["k2_launches"] + o["k2_launches"]}


# -- phase 20: the mesh ----------------------------------------------------------

# Readings that phase 20 prints beside its own: phase 6's bulk boards/s and
# phase 9's cover walls (absent under --mesh, which skips those phases).
SINGLE_DEVICE: dict = {}


def _wrap(module, name: str, make):
    """Swap ``module.name`` for ``make(original)``; returns the undo."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    return lambda: setattr(module, name, orig)


def _ring_rows(module):
    """Count the rows each ring steal of ``module`` installs, on the device:
    ``(undo, total)``, ``total()`` one host read after the run."""
    import torch

    got: list = []

    def make(orig):
        def counting(*args, **kw):
            out = orig(*args, **kw)
            got.append(torch.stack([n.to(out[0][0].device) for n in out[5]]).sum())
            return out
        return counting

    undo = _wrap(module, "_ring_steal", make)
    return undo, lambda: int(torch.stack(got).sum()) if got else 0


def _same_solutions(grids, got, want, what: str) -> int:
    """Every solution in ``got`` valid and keeping its givens, and equal to
    ``want``'s wherever the board has exactly one solution (the native
    oracle counts up to two): a board with several keeps the first one a
    lane finds, and which lane that is depends on how the lanes are cut
    into shards.  Returns how many multi-solution boards differ."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch import native

    n = len(grids)
    check_solutions(grids, got, np.ones(n, bool), np.zeros(n, bool), what)
    differ = np.flatnonzero((got != want).reshape(n, -1).any(1))
    if any(native.count_solutions(grids[i], limit=2) == 1 for i in differ):
        raise AssertionError(f"{what}: a board with one solution came back with another")
    return len(differ)


def _verdicts_match(grids, got, want, what: str) -> dict:
    """``solved`` and ``unsat`` bit-equal to the single-device result's,
    the solutions as :func:`_same_solutions` holds them."""
    import numpy as np

    g = {f: getattr(got, f).cpu().numpy() for f in ("solution", "solved", "unsat")}
    w = {f: getattr(want, f).cpu().numpy() for f in ("solution", "solved", "unsat")}
    for f in ("solved", "unsat"):
        if not np.array_equal(g[f], w[f]):
            raise AssertionError(f"{what}: {f} differs from the single-device solve")
    check_solutions(grids, g["solution"], g["solved"], g["unsat"], what)
    return {"boards": len(grids), "solutions_differ_on_multi_solution_boards":
            _same_solutions(grids, g["solution"], w["solution"], what)}


def _mesh_composite(mesh, corpus, sizes, dev, on_card, keep: dict) -> dict:
    """(a): ``solve_batch_sharded`` with ``SolverConfig()``, then one hard
    board among easy ones (the ring steal), then ``propagator="pallas"``
    (its result and wall kept in ``keep`` for phase 22)."""
    import numpy as np
    import torch

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
    from distributed_sudoku_solver_tpu_torch.parallel import sharded, solve_batch_sharded
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

    grids = corpus[: sizes["mesh_composite"]]
    single = solve_batch(grids, SUDOKU_9, SolverConfig(), device=dev)
    solve_batch_sharded(grids[:256], SUDOKU_9, SolverConfig(), mesh=mesh)  # warm-up
    syncs: dict = {}
    t0 = time.perf_counter()
    res = _count_syncs(lambda: solve_batch_sharded(grids, SUDOKU_9, SolverConfig(), mesh=mesh),
                       syncs if on_card else None, "solve")
    _sync(on_card)
    wall = time.perf_counter() - t0
    out = {"xla": {**_verdicts_match(grids, res, single, "(a) composite"), "wall_s": wall,
                   "steps": int(res.steps), "steals": int(res.steals),
                   "host_syncs": syncs.get("solve", 0)}}

    lonely = np.stack([HARD_9[0]] + [EASY_9] * (sizes["mesh_steal_easy"])).astype(np.int32)
    undo, rows = _ring_rows(sharded)
    try:
        r = solve_batch_sharded(lonely, SUDOKU_9, SolverConfig(), mesh=mesh)
    finally:
        undo()
    if not bool(r.solved.all()) or int(r.steals) <= 0 or rows() <= 0:
        raise AssertionError(f"(a) one hard board: solved {bool(r.solved.all())}, steals "
                             f"{int(r.steals)}, ring rows {rows()}")
    if not np.array_equal(r.solution[0].cpu().numpy(), hard9_solutions()[0]):
        raise AssertionError("(a) HARD_9[0] differs from the oracle's solution")
    out["one_hard"] = {"steals": int(r.steals), "ring_rows": rows(), "steps": int(r.steps)}

    cfg = SolverConfig(propagator="pallas")
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    syncs = {}
    t0 = time.perf_counter()
    rp = _count_syncs(lambda: solve_batch_sharded(grids, SUDOKU_9, cfg, mesh=mesh),
                      syncs if on_card else None, "solve")
    _sync(on_card)
    wall = time.perf_counter() - t0
    k1 = cuda_propagate.propagate_fixpoint_cuda.launches
    if on_card and k1 < mesh.size * int(rp.steps):
        raise AssertionError(f"(a) pallas: K1 launched {k1} times over {int(rp.steps)} rounds")
    for f in ("solution", "solved", "unsat"):
        if not torch.equal(getattr(rp, f), getattr(res, f)):
            raise AssertionError(f"(a) pallas: {f} differs from the xla mesh solve")
    out["pallas"] = {"wall_s": wall, "steps": int(rp.steps), "k1_launches": k1,
                     "host_syncs": syncs.get("solve", 0)}
    keep["a"] = {"result": rp, "wall_s": wall, "rounds": int(rp.steps)}
    log(f"[20] (a) composite on {mesh.size} shards: {json.dumps(out)}")
    return {"K1": k1, **out}


def _sync(on_card: bool) -> None:
    import torch

    if on_card:
        torch.cuda.synchronize()


def _fused_cfg():
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig

    # Phase 5's shape (the bulk first pass's kernel: S=12, extended, minrem).
    return SolverConfig(step_impl="fused", stack_slots=12, rules="extended", branch="minrem")


def _mesh_k2(mesh, corpus, sizes, dev, on_card, keep: dict) -> dict:
    """(b): ``solve_batch_fused_sharded`` on phase 5's shape against the
    single-device fused solve; K2's launches, ring rows, syncs per round."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
    from distributed_sudoku_solver_tpu_torch.parallel import fused_sharded
    from distributed_sudoku_solver_tpu_torch.parallel import solve_batch_fused_sharded

    grids = corpus[: sizes["mesh_k2"]]
    single = solve_batch(grids, SUDOKU_9, _fused_cfg(), device=dev)
    solve_batch_fused_sharded(grids[:1024], SUDOKU_9, _fused_cfg(), mesh=mesh)  # warm-up
    _sync(on_card)
    rounds = [0]

    def make(orig):
        def counting(*args, **kw):
            rounds[0] += 1
            return orig(*args, **kw)
        return counting

    undo_rounds = _wrap(fused_sharded, "_fused_round_sharded", make)
    undo_ring, ring_rows = _ring_rows(fused_sharded)
    syncs: dict = {}
    try:
        cuda_step.fused_rounds_cuda.launches = 0
        t0 = time.perf_counter()
        res = _count_syncs(lambda: solve_batch_fused_sharded(grids, SUDOKU_9, _fused_cfg(),
                                                             mesh=mesh),
                           syncs if on_card else None, "solve")
        _sync(on_card)
        wall = time.perf_counter() - t0
        k2 = cuda_step.fused_rounds_cuda.launches
    finally:
        undo_rounds()
        undo_ring()
    out = {**_verdicts_match(grids, res, single, "(b) K2 mesh"), "wall_s": wall,
           "boards_per_s": len(grids) / wall, "rounds": rounds[0], "k2_launches": k2,
           "ring_rows": ring_rows(), "host_syncs": syncs.get("solve", 0),
           "syncs_per_round": syncs.get("solve", 0) / max(rounds[0], 1),
           "steps": int(res.steps), "steals": int(res.steals)}
    if on_card and k2 < mesh.size * rounds[0]:
        raise AssertionError(f"(b) K2 launched {k2} times over {rounds[0]} rounds")
    if out["ring_rows"] <= 0:
        raise AssertionError("(b) the ring shipped no row")
    keep["b"] = {"result": res, "wall_s": wall, "rounds": rounds[0]}
    log(f"[20] (b) K2 on {mesh.size} shards: {json.dumps(out)}")
    return {"K2": k2, **out}


def _mesh_k2_plain(mesh, corpus, sizes, dev, on_card) -> dict:
    """(c): the sharded fused solve through K2, then with the plain rounds
    on the card; every field equal."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_step
    from distributed_sudoku_solver_tpu_torch.parallel import solve_batch_fused_sharded

    grids = corpus[: sizes["mesh_k2_plain"]]
    cuda_step.fused_rounds_cuda.launches = 0
    got = solve_batch_fused_sharded(grids, SUDOKU_9, _fused_cfg(), mesh=mesh)
    k2 = cuda_step.fused_rounds_cuda.launches
    undo = _wrap(cuda_step, "fused_rounds", lambda orig: cuda_step.fused_rounds_plain)
    try:
        want = solve_batch_fused_sharded(grids, SUDOKU_9, _fused_cfg(), mesh=mesh)
    finally:
        undo()
    _sync(on_card)
    err = max(max_abs_err(getattr(got, f), getattr(want, f)) for f in want._fields)
    if err or (on_card and (k2 <= 0 or cuda_step.fused_rounds_cuda.launches != k2)):
        raise AssertionError(f"(c) sharded K2 against plain: max_abs_err {err}, launches {k2}")
    out = {"boards": len(grids), "shard_lanes": len(grids) // mesh.size, "max_abs_err": err,
           "kernel_launches": k2}
    log(f"[20] (c) sharded K2 against its plain rounds: {json.dumps(out)}")
    return out


def _mesh_k3(mesh, dev, on_card, keep: dict) -> dict:
    """(d): ``solve_csp_fused_sharded`` at phase 9's width; exact counts."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
    from distributed_sudoku_solver_tpu_torch.parallel import solve_csp_fused_sharded

    out, k3 = {}, 0
    for name, problem, roots in cover_instances(full=False):
        cuda_cover.cover_fused_rounds_cuda.launches = 0
        syncs: dict = {}
        t0 = time.perf_counter()
        res = _count_syncs(lambda: solve_csp_fused_sharded(roots, problem, cover_config(),
                                                           mesh=mesh),
                           syncs if on_card else None, "solve")
        _sync(on_card)
        wall = time.perf_counter() - t0
        n = cuda_cover.cover_fused_rounds_cuda.launches
        count = int(res.sol_count[0])
        if count != COVER_COUNTS[name] or not bool(res.unsat[0]) or bool(res.overflowed[0]):
            raise AssertionError(f"(d) {name}: counted {count} (expected "
                                 f"{COVER_COUNTS[name]}), unsat {bool(res.unsat[0])}, "
                                 f"overflowed {bool(res.overflowed[0])}")
        if on_card and n < mesh.size:
            raise AssertionError(f"(d) {name}: K3 launched {n} times")
        k3 += n
        rounds = n // mesh.size
        keep[f"d {name}"] = {"result": res, "wall_s": wall, "rounds": rounds}
        out[name] = {"count": count, "wall_s": wall, "k3_launches": n, "rounds": rounds,
                     "host_syncs": syncs.get("solve", 0),
                     "syncs_per_round": syncs.get("solve", 0) / max(rounds, 1),
                     "steps": int(res.steps), "steals": int(res.steals),
                     "single_device_wall_s": SINGLE_DEVICE.get(f"cover {name}", "not run")}
    log(f"[20] (d) K3 on {mesh.size} shards: {json.dumps(out)}")
    return {"K3": k3, **out}


def _mesh_bulk(mesh, corpus, dev, on_card, keep: dict) -> dict:
    """(e): ``solve_bulk(..., mesh=mesh)`` over the whole corpus."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops import cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk

    cuda_step.fused_rounds_cuda.launches = 0
    cuda_propagate.propagate_fixpoint_cuda.launches = 0
    trace: dict = {}
    t0 = time.perf_counter()
    res = solve_bulk(corpus, SUDOKU_9, BulkConfig(), mesh=mesh, trace=trace)
    _sync(on_card)
    wall = time.perf_counter() - t0
    launches = {"K2": cuda_step.fused_rounds_cuda.launches,
                "K1": cuda_propagate.propagate_fixpoint_cuda.launches}
    check_solutions(corpus, res.solution, res.solved, res.unsat, "(e) bulk mesh")
    keep["e"] = {"result": res, "wall_s": wall, "rounds": None}
    if on_card and launches["K2"] <= 0:
        raise AssertionError("(e) the bulk mesh path launched K2 no time")
    out = {"boards": len(corpus), "wall_s": wall, "boards_per_s": len(corpus) / wall,
           "what": f"{mesh.size} virtual shards on one card",
           "single_device_boards_per_s": SINGLE_DEVICE.get("bulk boards/s", "not run"),
           "launches": launches, "remaining_after_first": trace["remaining_after_first"],
           "rungs": [{k: r[k] for k in ("lanes", "dispatches", "survivors_in", "survivors_out",
                                        "wall_s")} for r in trace["rungs"]]}
    log(f"[20] (e) bulk on {mesh.size} shards: {json.dumps(out)}")
    return {"K1": launches["K1"], "K2": launches["K2"], **out}


def _mesh_resident(corpus, sizes, dev, on_card) -> dict:
    """(f): the mesh-resident flight inside ``virtual_devices(4)`` against a
    single-device engine; then ``mesh_devices=4`` on the one card outside
    it, which must count ``mesh_unfit`` and still serve."""
    import numpy as np

    import distributed_sudoku_solver_tpu_torch.serving.engine as engine_mod
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.parallel import virtual_devices
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.mesh_scheduler import MeshResidentFlight
    from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    boards = [np.asarray(h) for h in HARD_9] + list(corpus[len(HARD_9):sizes["mesh_resident"]
                                                          + len(HARD_9)])
    shards = sizes["mesh_shards"]

    def serve(rc, count_fetches: bool):
        tags: list = []
        orig = engine_mod.host_fetch

        def counting(x, floor_s=0.0, tag="status"):
            tags.append(tag)
            return orig(x, floor_s=floor_s, tag=tag)

        if count_fetches:
            engine_mod.host_fetch = counting
        eng = SolverEngine(config=SolverConfig(), resident=rc, device=dev).start()
        try:
            t0 = time.perf_counter()
            jobs = [eng.submit(b) for b in boards]
            for j in jobs:
                if not j.wait(600) or not j.solved:
                    raise AssertionError(f"(f) a job failed: {j.error} {j.last_fault}")
            wall = time.perf_counter() - t0
            rf = eng._resident[SUDOKU_9]
            deadline = time.monotonic() + 60
            while any(s is not None for s in rf.slots) and time.monotonic() < deadline:
                time.sleep(0.01)
            return jobs, wall, rf, eng.metrics(), list(tags)
        finally:
            eng.stop(timeout=5)
            engine_mod.host_fetch = orig

    # A queue that holds every board, so no submit overflows to a static
    # flight (whose chunks would add status fetches of their own).
    depth = len(boards)
    single_jobs, single_wall, _, _, _ = serve(
        ResidentConfig(job_slots=16 * shards, gang_lanes=8, queue_depth=depth), False)
    with virtual_devices(shards):
        jobs, wall, rf, m, tags = serve(
            ResidentConfig(job_slots=16, gang_lanes=8, queue_depth=depth, mesh_devices=shards),
            True)
    if not isinstance(rf, MeshResidentFlight):
        raise AssertionError(f"(f) the engine built a {type(rf).__name__}")
    differ = _same_solutions(np.stack(boards).astype(np.int32),
                             np.stack([j.solution for j in jobs]),
                             np.stack([j.solution for j in single_jobs]), "(f) mesh flight")
    mesh_m = m["resident"]["9x9"]["mesh"]
    if m["resident"]["9x9"]["admitted"] != len(boards):
        raise AssertionError(f"(f) {m['resident']['9x9']['admitted']} of {len(boards)} admitted")
    if m.get("mesh_unfit", 0) or mesh_m["ring_shipped"] <= 0:
        raise AssertionError(f"(f) mesh_unfit {m.get('mesh_unfit', 0)}, mesh {mesh_m}")
    if tags.count("status") != rf.chunks:
        raise AssertionError(f"(f) {tags.count('status')} status fetches for {rf.chunks} chunks")
    out = {"boards": len(boards), "solutions_differ_on_multi_solution_boards": differ,
           "wall_s": wall, "single_device_wall_s": single_wall,
           "chunks": rf.chunks, "status_fetches": tags.count("status"),
           "event_fetches": tags.count("event"), "mesh": mesh_m}
    unfit_jobs, _, rf1, m1, _ = serve(
        ResidentConfig(job_slots=16, gang_lanes=8, mesh_devices=shards), False)
    if isinstance(rf1, MeshResidentFlight) or m1.get("mesh_unfit", 0) < 1:
        raise AssertionError("(f) mesh_devices=4 on one card did not fall back (mesh_unfit)")
    out["one_card_mesh_unfit"] = m1["mesh_unfit"]
    log(f"[20] (f) mesh-resident flight: {json.dumps(out)}")
    return out


def banded_cases() -> list:
    """(name, geometry, grids, config) of the banded path: HARD_9 with the
    extended rules and one carved 25x25 board."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_25
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle

    return [("9x9", SUDOKU_9, np.stack(HARD_9).astype(np.int32),
             SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096, rules="extended")),
            ("25x25", SUDOKU_25, make_puzzle(SUDOKU_25, seed=3, n_clues=480, unique=False)[None],
             SolverConfig(min_lanes=4, stack_slots=48, max_steps=50_000))]


def _mesh_banded(mesh, dev, keep: dict) -> dict:
    """(g): ``solve_batch_banded``: HARD_9 and a 25x25 board, every field
    bit-exact against the single-device ``solve_batch``."""
    import torch

    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
    from distributed_sudoku_solver_tpu_torch.parallel import make_band_mesh, solve_batch_banded

    band = make_band_mesh(mesh.devices)
    out = {}
    for name, geom, grids, cfg in banded_cases():
        ref = solve_batch(grids, geom, cfg, device=dev)
        t0 = time.perf_counter()
        res = solve_batch_banded(grids, geom, cfg, mesh=band)
        wall = time.perf_counter() - t0
        for f in ref._fields:
            if not torch.equal(getattr(res, f), getattr(ref, f)):
                raise AssertionError(f"(g) banded {name}: {f} differs from solve_batch")
        if not bool(res.solved.all()):
            raise AssertionError(f"(g) banded {name}: unsolved")
        out[name] = {"wall_s": wall, "nodes": int(res.nodes.sum()), "steps": int(res.steps),
                     "sweeps": int(res.sweeps)}
        keep[f"g {name}"] = {"result": res, "wall_s": wall, "rounds": int(res.steps)}
    log(f"[20] (g) banded on {band.size} shards: {json.dumps(out)}")
    return out


def _mesh_cli(dev, on_card) -> dict:
    """(h): ``cli.main([... "--sharded"])`` in process answers one
    ``POST /solve`` through ``solve_batch_sharded`` over ``default_mesh()``."""
    import numpy as np

    from distributed_sudoku_solver_tpu_torch import cli
    from distributed_sudoku_solver_tpu_torch.parallel import sharded
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9

    sizes_seen: list = []

    def make(orig):
        def counting(states0, problem, config, mesh):
            sizes_seen.append(mesh.size)
            return orig(states0, problem, config, mesh)
        return counting

    http_port, p2p_port = _free_ports(2)
    stop = threading.Event()
    errors: list = []
    argv = ["-p", str(http_port), "-s", str(p2p_port), "--host", "127.0.0.1",
            "--advertise-host", "127.0.0.1", "--sharded", "--no-frontdoor"]

    def run():
        try:
            cli.main(argv, device=None if on_card else dev, stop=stop)
        except BaseException as e:  # reported below
            errors.append(e)

    undo = _wrap(sharded, "_solve_csp_sharded", make)
    t = threading.Thread(target=run, name="cli-sharded", daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                _http(http_port, "/network", timeout=2)
                break
            except OSError:
                if time.monotonic() > deadline or errors:
                    raise AssertionError(f"(h) the --sharded node never came up: {errors}")
                time.sleep(0.1)
        t0 = time.perf_counter()
        status, _, body = _http(http_port, "/solve", {"sudoku": np.asarray(HARD_9[0]).tolist()})
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        t.join(60)
        undo()
    if t.is_alive() or errors:
        raise AssertionError(f"(h) the --sharded node did not stop cleanly: {errors}")
    if status != 201 or not np.array_equal(np.asarray(body["solution"]), hard9_solutions()[0]):
        raise AssertionError(f"(h) POST /solve answered {status}: {body}")
    if set(sizes_seen) != {1}:
        raise AssertionError(f"(h) solve_batch_sharded ran on meshes {sizes_seen}")
    out = {"status": status, "wall_s": wall, "mesh_sizes": sorted(set(sizes_seen))}
    log(f"[20] (h) --sharded node: {json.dumps(out)}")
    return out


def phase_mesh(corpus, device, sizes, dev) -> dict:
    """Phase 20: the mesh, four virtual shards on the one card (``parallel.
    virtual_devices``).  Returns the mesh paths' launches of K1, K2, K3,
    and under ``"paths"`` the results, walls and rounds of (a) (``pallas``),
    (b), (d), (e) and (g), which phase 22 holds the process mesh against."""
    from distributed_sudoku_solver_tpu_torch.parallel import make_mesh, virtual_devices

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    paths: dict = {}
    with virtual_devices(sizes["mesh_shards"]):
        mesh = make_mesh(device=dev)
        if mesh.size != sizes["mesh_shards"] or len(set(mesh.devices)) != 1:
            raise AssertionError(f"(20) the mesh is {mesh.devices}")
        a = _mesh_composite(mesh, corpus, sizes, dev, on_card, paths)
        b = _mesh_k2(mesh, corpus, sizes, dev, on_card, paths)
        c = _mesh_k2_plain(mesh, corpus, sizes, dev, on_card)
        d = _mesh_k3(mesh, dev, on_card, paths)
        e = _mesh_bulk(mesh, corpus, dev, on_card, paths)
        g = _mesh_banded(mesh, dev, paths)
    f = _mesh_resident(corpus, sizes, dev, on_card)
    h = _mesh_cli(dev, on_card)
    wall = time.perf_counter() - t0
    log(f"[20] {device['smi']}; phase wall {wall:.1f} s")
    log(json.dumps({"mesh": {"composite": a, "k2": b, "k2_plain": c, "k3": d, "bulk": e,
                             "resident": f, "banded": g, "cli": h, "phase_wall_s": wall,
                             "card": device["smi"]}}, default=str))
    return {"K1": a["K1"] + e["K1"], "K2": b["K2"] + e["K2"], "K3": d["K3"], "paths": paths}


# -- phase 22: the process mesh ------------------------------------------------

# The gloo group's timeout: a worker whose peer died fails its collective
# within this many seconds instead of waiting for ever.
PROCMESH_GLOO_TIMEOUT_S = 120


def _procmesh_paths(corpus, sizes):
    """(key, run, warm-up or None) of every phase-22 path, at phase 20's
    shapes: (a) the composite solve through K1, (b) K2, (d) K3 on each
    cover instance, (e) bulk, (g) each banded case."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.parallel import (
        solve_batch_banded,
        solve_batch_fused_sharded,
        solve_batch_sharded,
        solve_csp_fused_sharded,
    )

    pallas = SolverConfig(propagator="pallas")
    grids_a, grids_b = corpus[: sizes["mesh_composite"]], corpus[: sizes["mesh_k2"]]
    paths = [
        ("a", lambda m: solve_batch_sharded(grids_a, SUDOKU_9, pallas, mesh=m),
         lambda m: solve_batch_sharded(grids_a[:256], SUDOKU_9, pallas, mesh=m)),
        ("b", lambda m: solve_batch_fused_sharded(grids_b, SUDOKU_9, _fused_cfg(), mesh=m),
         lambda m: solve_batch_fused_sharded(grids_b[:1024], SUDOKU_9, _fused_cfg(), mesh=m)),
    ]
    for name, problem, roots in cover_instances(full=False):
        paths.append((f"d {name}", lambda m, p=problem, r=roots: solve_csp_fused_sharded(
            r, p, cover_config(), mesh=m), None))
    paths.append(("e", lambda m: solve_bulk(corpus, SUDOKU_9, BulkConfig(), mesh=m), None))
    for name, geom, grids, cfg in banded_cases():
        paths.append((f"g {name}", lambda m, g=grids, ge=geom, c=cfg: solve_batch_banded(
            g, ge, c, mesh=m), None))
    return paths


def _result_arrays(key: str, res) -> dict:
    """Every field of a ``SolveResult`` or ``BulkResult`` as numpy arrays."""
    import numpy as np

    fields = res._asdict() if hasattr(res, "_asdict") else vars(res)
    return {f"{key}/{name}": (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for name, v in fields.items()}


def procmesh_worker(rank: int, world: int, workdir: str, dev_type: str) -> int:
    """One process of phase 22 (``chip_smoke.py --procmesh-worker``): joins
    the gloo group through the file store in ``workdir``, builds this
    process's part of the mesh and runs every path once, counting its
    kernels' launches from zero, its host syncs, its rounds and its
    cross-process traffic; writes ``result<rank>.npz`` and ``.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_sudoku_solver_tpu_torch.ops import (
        cuda_build,
        cuda_cover,
        cuda_propagate,
        cuda_step,
    )
    from distributed_sudoku_solver_tpu_torch.parallel import (
        fused_sharded,
        make_process_mesh,
        sharded,
        virtual_devices,
    )

    torch.set_num_threads(1)
    dev = torch.device(dev_type)
    on_card = dev.type == "cuda"
    corpus = np.load(os.path.join(workdir, "corpus.npy"))
    wrappers = {"K1": cuda_propagate.propagate_fixpoint_cuda,
                "K2": cuda_step.fused_rounds_cuda, "K3": cuda_cover.cover_fused_rounds_cuda}
    rounds, built = [0], {}

    def counting(orig):
        def round_(*args, **kw):
            rounds[0] += 1
            return orig(*args, **kw)
        return round_

    def recording(orig):  # the libraries phase 2 built must load, not build again
        def build(targets):
            out = orig(targets)
            built.update(out)
            return out
        return build

    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "store"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PROCMESH_GLOO_TIMEOUT_S))
    undo = [_wrap(sharded, "_sharded_step_counted", counting),
            _wrap(fused_sharded, "_fused_round_sharded", counting),
            _wrap(cuda_build, "_build", recording)]
    arrays, stats = {}, {}
    try:
        k = SIZES["procmesh_shards"]
        with virtual_devices(k):
            mesh = make_process_mesh(k, device=dev)
        if mesh.procs != world or mesh.size != world * k or len(set(mesh.devices)) != 1:
            raise AssertionError(f"(22) rank {rank}: the mesh is {mesh}")
        for key, run, warm in _procmesh_paths(corpus, SIZES):
            if warm is not None:
                warm(mesh)
                _sync(on_card)
            for w in wrappers.values():
                w.launches = 0
            rounds[0] = 0
            before = mesh.traffic.snapshot()
            syncs: dict = {}
            t0 = time.perf_counter()
            res = _count_syncs(lambda: run(mesh), syncs if on_card else None, "solve")
            _sync(on_card)
            wall = time.perf_counter() - t0
            after = mesh.traffic.snapshot()
            arrays.update(_result_arrays(key, res))
            # The banded path runs the one-device frontier loop: its rounds
            # are the result's steps.
            stats[key] = {"wall_s": wall, "rounds": rounds[0] or int(res.steps),
                          "host_syncs": syncs.get("solve", 0) if on_card else "not measured",
                          "launches": {name: w.launches for name, w in wrappers.items()},
                          "traffic": {f: after[f] - before[f] for f in after}}
    finally:
        for u in undo:
            u()
        dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"result{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"result{rank}.json"), "w") as f:
        json.dump({"rank": rank, "local": list(mesh.local), "paths": stats,
                   "built": sorted(built)}, f)
    return 0


def _spawn_workers(world: int, workdir: str, dev, limit_s: float) -> list:
    """Start the workers, wait for them under one deadline, and reap them on
    every exit path; returns each worker's exit code (a string when it was
    killed at the deadline) and the tail of its output."""
    procs, logs = [], []
    try:
        for rank in range(world):
            logs.append(open(os.path.join(workdir, f"worker{rank}.log"), "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--procmesh-worker", str(rank),
                 str(world), workdir, dev.type],
                cwd=REPO, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + limit_s
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append(f"killed after {limit_s:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = []
    for rank in range(world):
        with open(os.path.join(workdir, f"worker{rank}.log"), "rb") as f:
            tails.append(f.read()[-4000:].decode(errors="replace"))
    return list(zip(rcs, tails))


def phase_procmesh(corpus, device, sizes, dev, mesh20: dict) -> dict:
    """Phase 22: the process mesh.  Two worker processes (this script with
    ``--procmesh-worker``) join one gloo group and each drives two shards of
    a four-shard ``make_process_mesh`` on the one card; every path's result
    must equal in both workers, and equal phase 20's one-process four-shard
    result (``mesh20["paths"]``) on every field.  Returns the workers'
    launches of K1, K2 and K3."""
    import shutil

    import numpy as np

    on_card = dev.type == "cuda"
    world, k = sizes["procmesh_procs"], sizes["procmesh_shards"]
    if world * k != sizes["mesh_shards"]:
        raise AssertionError("(22) the process mesh must have phase 20's shard count")
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="procmesh-")
    try:
        np.save(os.path.join(workdir, "corpus.npy"), corpus)
        workers = _spawn_workers(world, workdir, dev, sizes["procmesh_limit_s"])
        if any(rc != 0 for rc, _ in workers):
            raise AssertionError("(22) a worker failed:\n" + "".join(
                f"--- worker {r} (rc={rc}) ---\n{tail}\n" for r, (rc, tail) in enumerate(workers)))
        results, reports = [], []
        for rank in range(world):
            with np.load(os.path.join(workdir, f"result{rank}.npz")) as f:
                results.append({name: f[name] for name in f.files})
            with open(os.path.join(workdir, f"result{rank}.json")) as f:
                reports.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    want = {}
    for key, kept in mesh20["paths"].items():
        want.update(_result_arrays(key, kept["result"]))
    for rank, (got, report) in enumerate(zip(results, reports)):
        if report["local"] != list(range(rank * k, (rank + 1) * k)):
            raise AssertionError(f"(22) worker {rank} drove shards {report['local']}")
        if report["built"]:
            raise AssertionError(f"(22) worker {rank} built {report['built']} again")
        if set(got) != set(want):
            raise AssertionError(f"(22) worker {rank}: fields {sorted(set(got) ^ set(want))}")
        for name, w in want.items():
            if not np.array_equal(got[name], w):
                raise AssertionError(f"(22) worker {rank}: {name} differs from phase 20's "
                                     f"one-process four-shard result")
    got = results[0]
    for key, grids in (("a", corpus[: sizes["mesh_composite"]]),
                       ("b", corpus[: sizes["mesh_k2"]]), ("e", corpus)):
        check_solutions(grids, got[f"{key}/solution"], got[f"{key}/solved"],
                        got[f"{key}/unsat"], f"(22) {key}")
    for name, _, _ in cover_instances(full=False):
        count = int(got[f"d {name}/sol_count"][0])
        if count != COVER_COUNTS[name] or not got[f"d {name}/unsat"][0]:
            raise AssertionError(f"(22) {name}: counted {count}")
    for name, *_ in banded_cases():
        if not got[f"g {name}/solved"].all():
            raise AssertionError(f"(22) banded {name}: unsolved")

    # Each worker launched each kernel of its paths, on its own shards, once
    # a round per shard at least (the counts are zeroed before every path).
    kernel_of = {"a": "K1", "b": "K2", "e": "K2", "d": "K3"}
    launches = {"K1": 0, "K2": 0, "K3": 0}
    for rank, report in enumerate(reports):
        for key, st in report["paths"].items():
            for name, n in st["launches"].items():
                launches[name] += n
            kernel = kernel_of.get(key.split()[0])
            floor = k * st["rounds"] if key != "e" else 1
            if on_card and kernel and st["launches"][kernel] < floor:
                raise AssertionError(f"(22) worker {rank} {key}: {kernel} launched "
                                     f"{st['launches'][kernel]} times over {st['rounds']} rounds")
    out = {}
    for key, kept in mesh20["paths"].items():
        per = [r["paths"][key] for r in reports]
        n_rounds = max(per[0]["rounds"], 1)
        row = {"wall_s": [p["wall_s"] for p in per], "phase20_wall_s": kept["wall_s"],
               "rounds": per[0]["rounds"], "phase20_rounds": kept["rounds"],
               "host_syncs_per_round": [p["host_syncs"] / n_rounds
                                        if on_card else "not measured" for p in per],
               "cross_process_per_round": [
                   {f: p["traffic"][f] / n_rounds for f in ("calls", "bytes", "seconds",
                                                             "stage_seconds")} for p in per],
               "launches": [p["launches"] for p in per]}
        out[key] = row
        log(f"[22] ({key}) walls {[round(w, 4) for w in row['wall_s']]} s (phase 20: "
            f"{kept['wall_s']:.4f} s); rounds {row['rounds']} (phase 20: {kept['rounds']}); "
            f"host syncs per round {row['host_syncs_per_round']}; per round across processes "
            f"{json.dumps(row['cross_process_per_round'])}; launches {row['launches']}")
    wall = time.perf_counter() - t0
    log(f"[22] {world} processes x {k} shards on one card, every path equal in both workers "
        f"and to phase 20's; {device['smi']}; phase wall {wall:.1f} s")
    log(json.dumps({"procmesh": {"paths": out, "launches": launches, "phase_wall_s": wall,
                                 "card": device["smi"]}}))
    return launches


# -- phase 21: the compile watch, the cost plane and the analysis runner ------


class _LogLines:
    """Collects the messages a logger emits (the watch's ``[compile ...]``
    lines)."""

    def __init__(self, name: str):
        import logging

        self.lines: list = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda record: self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


# The libraries phase 21's nodes build through cuda_build.load at first use.
NODE_TARGETS = (("fused_step", ""), ("bookkeep", ""), ("propagate", ""))
# The smoke's build of every other library (one nvcc each, all at once).
SMOKE_BUILD = (
    "import json\n"
    "from distributed_sudoku_solver_tpu_torch.ops import cuda_build as b\n"
    f"print(json.dumps(b.build(b.TARGETS + {COUNTER_TARGETS!r})))\n")


def _smoke_build_seconds(proc) -> dict:
    """Waits for the smoke's build process; each library's nvcc seconds."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"(21) the smoke's build failed: rc {proc.returncode}\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _compile_section(port: int) -> dict:
    status, _, body = _http(port, "/metrics")
    if status != 200 or "compile" not in body:
        raise AssertionError(f"(21) /metrics: {status}, compile section "
                             f"{'compile' in body if isinstance(body, dict) else body}")
    return body


def _sync_turns(port, rf_of, mf_of, boards, hard, watch,
                turns=("warm-up", "on", "off", "off", "on")):
    """Host syncs per resident chunk and per megastep flight, the compile
    watch installed or not, in turns; requests one at a time so that every
    turn serves the same chunks.  The warm-up turn (watch on) is not
    compared: its first chunk also detaches the previous pass's last job."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import geometry_for_size
    from distributed_sudoku_solver_tpu_torch.obs import compilewatch

    geom_of = lambda b: geometry_for_size(b.shape[0])  # noqa: E731
    out: dict = {"resident_per_chunk": {"warm-up": [], "on": [], "off": []},
                 "latency_per_flight": {"warm-up": [], "on": [], "off": []}}
    try:
        for turn in turns:
            compilewatch.install(None if turn == "off" else watch)
            rf, before = rf_of(), rf_of().chunks
            (res, _), n = _syncs_during(lambda: _post_all(port, boards, threads=1))
            _check_answers(boards, res, geom_of, f"(21) resident syncs, watch {turn}")
            out["resident_per_chunk"][turn].append(n / max(1, rf.chunks - before))
            mf, before = mf_of(), mf_of().flights
            (res, _), n = _syncs_during(lambda: _post_all(port, hard, threads=1,
                                                          path="/solve?latency=1"))
            _check_answers(hard, res, geom_of, f"(21) latency syncs, watch {turn}")
            out["latency_per_flight"][turn].append(n / max(1, mf.flights - before))
    finally:
        compilewatch.install(watch)
    for route, row in out.items():
        if set(row["on"]) != set(row["off"]) or len(set(row["on"])) != 1:
            raise AssertionError(f"(21) {route}: host syncs with the watch on {row['on']} "
                                 f"and off {row['off']} differ")
    return out


def phase_compile(corpus, device, sizes, dev) -> dict:
    """Phase 21: a node booted through ``cli.main`` with its compile watch,
    on a process where no kernel library is loaded yet: (a) warmup, the
    nodes' first requests building and loading K2's and K1's libraries
    under the watch (the time to a serving node), the smoke's build of the
    other libraries in a process of its own, and phase 17's mix, (b)
    a second pass after the seal with zero recompiles and the same host
    syncs with the watch on and off, (c) two forced first loads after the
    seal, each one recompile, one log line and one dump, the second after
    the re-arm, (d) the cost plane, Prometheus and Perfetto exports, (e)
    the analysis runner.  Returns the phase's K1, K2 and K3 launches."""
    import dataclasses

    import numpy as np

    from distributed_sudoku_solver_tpu_torch import cli
    from distributed_sudoku_solver_tpu_torch.models.geometry import (
        SUDOKU_9,
        SUDOKU_16,
        geometry_for_size,
    )
    from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
    from distributed_sudoku_solver_tpu_torch.obs import compilewatch, critpath, promck, trace, traceck
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build, cuda_cover, cuda_propagate, cuda_step
    from distributed_sudoku_solver_tpu_torch.ops.cost import advance_round_cost
    from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp
    from distributed_sudoku_solver_tpu_torch.probes import cover_kernel
    from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
    from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer, StandaloneNode
    from distributed_sudoku_solver_tpu_torch.utils.oracle import count_solutions
    from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle, to_line

    if cuda_build._loaded or any(cuda_build.lib_path(*t).exists() for t in NODE_TARGETS):
        raise AssertionError(f"(21) a library of the nodes is built or loaded already: "
                             f"{sorted(cuda_build._loaded)}")
    t_phase = time.perf_counter()
    # The smoke's own reference (the native oracle, g++), before any watch.
    hard9_solutions()
    geom_of = lambda b: geometry_for_size(b.shape[0])  # noqa: E731
    hard9 = [np.asarray(h, np.int32) for h in HARD_9]
    peak = PEAK_INT32_OPS_PER_S / 1e9
    rearm_s = 5.0
    out: dict = {"card": device["smi"]}
    # Node F's config: the CLI's engine with the fused step (K2).  The CLI
    # has no flag for the step, as the JAX CLI has none.
    engines: list = []
    make_engine = cli.make_engine

    def fused_engine(args, device=None):
        eng = make_engine(args, device=device)
        eng.config = dataclasses.replace(eng.config, step_impl="fused")
        engines.append(eng)
        return eng

    http_port, p2p_port = _free_ports(2)
    stop = threading.Event()
    errors: list = []
    dump_dir = tempfile.mkdtemp(prefix="dsst-compile-")
    argv = ["-p", str(http_port), "-s", str(p2p_port), "--host", "127.0.0.1",
            "--advertise-host", "127.0.0.1", "--no-frontdoor", "--trace", "--trace-dump",
            dump_dir, "--compile-warmup", "600", "--compile-rearm", str(rearm_s),
            "--peak-gflops", str(peak)]

    on_card = dev.type == "cuda"

    def run():
        try:
            cli.main(argv, device=None if on_card else dev, stop=stop)
        except BaseException as e:  # reported below
            errors.append(e)

    def dumps():
        return sorted(f for f in os.listdir(dump_dir) if "recompile" in f)

    cli.make_engine = fused_engine
    node = threading.Thread(target=run, name="cli-compile", daemon=True)
    eng_c = api_c = smoke_build = None
    for k in (cuda_step.fused_rounds_cuda, cuda_propagate.propagate_fixpoint_cuda,
              cuda_cover.cover_fused_rounds_cuda):
        k.launches = 0
    t_boot = time.perf_counter()
    node.start()
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                _http(http_port, "/network", timeout=2)
                break
            except OSError:
                if time.monotonic() > deadline or errors:
                    raise AssertionError(f"(21) the node never came up: {errors}")
                time.sleep(0.1)
        watch = compilewatch.active()
        if not isinstance(watch, compilewatch.CompileWatch) or watch.peak_gflops != peak:
            raise AssertionError(f"(21) cli.main installed no compile watch at "
                                 f"--peak-gflops {peak}: {watch}")
        eng = engines[0]
        up_s = time.perf_counter() - t_boot
        # (a) A node builds nothing at boot: its first request's first
        # advance loads K2's library through cuda_build.load, which builds
        # it, under the node's watch.  Node F's first request is alone on
        # the host, so its wall is the time to a serving node.
        base = len(HARD_9)
        first = [corpus[base + sizes["compile_mass"] + sizes["compile_mass"] // 2]]
        res, f_wall = _post_all(http_port, first, threads=1)
        _check_answers(first, res, geom_of, "(21) node F's first request")
        f_serving_s = time.perf_counter() - t_boot
        # Node C (composite, K1), in process: its first static request
        # builds and loads K1's library the same way.
        eng_c = SolverEngine(config=SolverConfig(propagator="pallas"), max_batch=256,
                             chunk_steps=64, resident=None, device=dev).start()
        api_c = ApiServer(StandaloneNode(eng_c, address="127.0.0.1:c"), host="127.0.0.1",
                          port=0, solve_timeout_s=600).start()
        first_c = [corpus[base + 5000 + sizes["compile_static"]]]
        res, c_wall = _post_all(api_c.port, first_c, threads=1, retry_429=False)
        _check_answers(first_c, res, geom_of, "(21) node C's first request")
        sec = _compile_section(http_port)["compile"]
        nodes = {name: {k: rec.get(k) for k in ("builds", "loads", "wall_ms_total")}
                 for name, rec in sec["programs"].items()}
        if (set(nodes) != {lib for lib, _ in NODE_TARGETS}
                or any(r["builds"] != 1 or r["loads"] != 1 for r in nodes.values())):
            raise AssertionError(f"(21) (a) the nodes' first requests did not build and load "
                                 f"K2's, the bookkeeping's and K1's libraries once each: {nodes}")
        out["time_to_serving"] = {"node_up_s": up_s, "node_f_first_answer_s": f_serving_s,
                                  "node_f_first_request_s": f_wall, "node_c_first_request_s": c_wall,
                                  "libraries": nodes}
        log(f"[21] (a) node F up with the compile watch (warmup 600 s, re-arm {rearm_s} s, peak "
            f"{peak} G int32 ops/s) in {up_s:.2f} s, building nothing; its first request "
            f"answered after {f_wall:.2f} s ({f_serving_s:.2f} s from the start), node C's "
            f"after {c_wall:.2f} s; the nodes' builds and first loads: {json.dumps(nodes)}")
        # The libraries no node has used yet, built by the smoke in a process
        # of its own (so no watch hears of it) beside the rest of the phase:
        # (c) needs cover and probe_cover on disk and not loaded, and phase 2
        # reports ptxas's view of every build.
        smoke_build = subprocess.Popen(
            [sys.executable, "-c", SMOKE_BUILD], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        # Pass A, inside the warmup: phase 17's routes on node F (9x9, so
        # the fused advance runs one shape) and node C (static, K1, and
        # the 16x16 boards).
        mass = [corpus[base + i] for i in range(sizes["compile_mass"])] + hard9
        res, wall = _post_all(http_port, mass, threads=sizes["serving_clients"])
        _check_answers(mass, res, geom_of, "(21) resident")
        if any(r[0] != 201 for r in res):
            raise AssertionError("(21) a resident request was not answered 201 after retries")
        routes = [_route_line("resident", res, wall, "[21]")]
        lres, lwall = _post_all(http_port, hard9, threads=1, path="/solve?latency=1")
        _check_answers(hard9, lres, geom_of, "(21) latency")
        for h, r in zip(hard9_solutions(), lres):
            if not np.array_equal(np.asarray(r[2]["solution"]), h):
                raise AssertionError("(21) a latency answer differs from the oracle's")
        routes.append(_route_line("latency", lres, lwall, "[21]"))
        # (d) The cost plane, read while the fused advance has one shape.
        m = _compile_section(http_port)
        cost = m["cost"]["programs"]["advance_fused_status"]
        want = advance_round_cost(SUDOKU_9, cost["lanes"], "basic")
        eff = m["cost"]["efficiency"]
        if (cost["lanes"] != 128 or cost["flops"] != want["flops"] or cost["unit"] != "int32_ops"
                or eff.get("achieved_gflops_per_s", 0) <= 0
                or not 0 < eff.get("device_efficiency", 0) <= 1.05):
            raise AssertionError(f"(21) cost plane: {cost} {eff}")
        out["cost"] = {"advance_fused_status": cost, "efficiency": eff,
                       "megastep": m["cost"]["programs"].get("advance_megastep_fused")}
        log(f"[21] (d) cost: K2 advance {cost['flops']:.0f} int32 ops and "
            f"{cost['bytes_accessed']:.0f} bytes a round at {cost['lanes']} lanes; achieved "
            f"{eff['achieved_rounds_per_s']} rounds/s = {eff['achieved_gflops_per_s']} G int32 "
            f"ops/s, device efficiency {eff['device_efficiency']} of the ceiling "
            f"{eff['ceiling_rounds_per_s']} rounds/s")
        sol0 = hard9_solutions()[0]
        multi = np.where(np.isin(sol0, (1, 2)), 0, sol0).astype(np.int32)
        st, _, body = _http(http_port, "/solve", {"sudoku": multi.tolist(), "count_all": True})
        if st != 200 or body["count"] != count_solutions(multi, SUDOKU_9, limit=10_000):
            raise AssertionError(f"(21) count_all: {st} {body}")
        bulk = corpus[base:base + sizes["compile_bulk"]]
        st, _, body = _http(http_port, "/solve_batch",
                            {"lines": [to_line(b) for b in bulk], "size": 9})
        if st != 200 or body["solved"] != len(bulk) or body["unsat"]:
            raise AssertionError(f"(21) solve_batch: {st}, solved {body.get('solved')}")
        b16 = [make_puzzle(SUDOKU_16, 100 + i, unique=False).astype(np.int32) for i in range(16)]
        static = [corpus[base + 5000 + i] for i in range(sizes["compile_static"])] + b16
        sres, swall = _post_all(api_c.port, static, threads=64, retry_429=False)
        _check_answers(static, sres, geom_of, "(21) static")
        if any(r[0] != 201 for r in sres):
            raise AssertionError("(21) a static-flight request was not answered 201")
        routes.append(_route_line("static", sres, swall, "[21]"))
        m = _compile_section(http_port)
        sec = m["compile"]
        libraries = {name: {k: rec.get(k) for k in ("builds", "loads", "wall_ms_total")}
                     for name, rec in sec["programs"].items()}
        if libraries != nodes or sec["recompiles_total"] or sec["warmup_over"]:
            raise AssertionError(f"(21) pass A built or loaded more than its first requests: {sec}")
        if m["cost"]["efficiency"].get("suppressed") != "mixed_shapes":
            raise AssertionError(f"(21) the gauge priced two shapes of the advance: {m['cost']}")
        out["libraries"] = libraries
        out["cache"] = sec["cache"]
        log(f"[21] (a) after pass A, per library (builds, first loads, build ms): "
            f"{json.dumps(libraries)}; cache {json.dumps(sec['cache'])}; count_all's static "
            f"flight made the fused advance two shapes, so the gauge reads suppressed: "
            f"mixed_shapes")
        # (b) Seal, then a second pass: no build, no first load.
        watch.seal()
        mass_b = [corpus[base + sizes["compile_mass"] + i] for i in range(sizes["compile_mass"] // 2)]
        res, wall = _post_all(http_port, mass_b, threads=sizes["serving_clients"])
        _check_answers(mass_b, res, geom_of, "(21) pass B resident")
        routes.append(_route_line("resident B", res, wall, "[21]"))
        sres, _ = _post_all(api_c.port, static[:32], threads=32, retry_429=False)
        _check_answers(static[:32], sres, geom_of, "(21) pass B static")
        rflights = {rf.geom: rf for rf in eng._resident_flights()}
        mflights = {mf.geom: mf for mf in eng._megastep_flights()}
        syncs = _sync_turns(http_port, lambda: rflights[SUDOKU_9], lambda: mflights[SUDOKU_9],
                            [corpus[base + 9000 + i] for i in range(sizes["compile_sync"])],
                            hard9, watch)
        out["syncs"] = syncs
        sec = _compile_section(http_port)["compile"]
        if sec["recompiles_total"] != 0 or not sec["warmup_over"] or sec["dumps"] != 0:
            raise AssertionError(f"(21) (b) after the seal: {sec}")
        log(f"[21] (b) sealed; pass B: 0 recompiles; host syncs in turns (warm-up, then "
            f"watch on, off, off, on): {json.dumps(syncs)}")
        # (c) First use of a library not loaded yet: K3 (a fused cover
        # enumeration), then, after the re-arm, the cover probe's kernel.
        # Both are on disk once the smoke's build is done: a first load each.
        out["smoke_build"] = _smoke_build_seconds(smoke_build)
        smoke_build = None
        log(f"[21] the smoke's build beside the phase (no node's): "
            f"{json.dumps({k: round(v, 2) for k, v in out['smoke_build'].items()})}")
        with _LogLines(compilewatch.__name__) as lines:
            t_load = time.monotonic()
            queens = nqueens_cover(12)
            res = solve_csp(queens.initial_state()[None], queens, cover_config(), device=dev)
            if int(res.sol_count[0]) != COVER_COUNTS["nqueens12"]:
                raise AssertionError(f"(21) n-queens 12 counted {int(res.sol_count[0])}")
            sec = _compile_section(http_port)["compile"]
            # Unarmed until rearm_s of quiet have passed since the load.
            unarmed = time.monotonic() - t_load < rearm_s
            alarms = [x for x in lines if x.startswith("[compile ")]
            if (sec["recompiles_total"] != 1 or sec["programs"]["cover"].get("recompiles") != 1
                    or sec["dumps"] != 1 or len(dumps()) != 1 or (unarmed and sec["armed"])
                    or alarms != [x for x in alarms if x.startswith("[compile cover]")]
                    or len(alarms) != 1):
                raise AssertionError(f"(21) (c) first load of cover: {sec}, log {lines}, "
                                     f"dumps {dumps()}")
            doc = json.loads(open(os.path.join(dump_dir, dumps()[0])).read())
            if doc["metrics"]["program"] != "cover" or doc["metrics"]["kind"] != "load":
                raise AssertionError(f"(21) (c) the dump: {doc['metrics']}")
            log(f"[21] (c) K3's first load after the seal: recompiles 1, log {alarms[0]!r}, "
                f"dump {dumps()[0]}")
            time.sleep(rearm_s + 0.5)
            sec = _compile_section(http_port)["compile"]
            if not sec["armed"]:
                raise AssertionError(f"(21) (c) the alarm did not re-arm after {rearm_s} s")
            cover_kernel.run_probe(dev)
            sec = _compile_section(http_port)["compile"]
            alarms = [x for x in lines if x.startswith("[compile ")]
            if (sec["recompiles_total"] != 2 or sec["dumps"] != 2 or len(dumps()) != 2
                    or len(alarms) != 2 or not alarms[1].startswith("[compile probe_cover]")):
                raise AssertionError(f"(21) (c) after the re-arm: {sec}, log {lines}")
        out["alarms"] = {"recompiles_total": sec["recompiles_total"], "dumps": dumps(),
                         "log": alarms}
        log(f"[21] (c) re-armed after {rearm_s} s of quiet; the cover probe's first load "
            f"fired the second dump {dumps()[1]}")
        # (d) The exports: Prometheus through promck, Perfetto through traceck.
        st, _, text = _http(http_port, "/metrics?format=prometheus")
        errors_prom = promck.check_text(text)
        if st != 200 or errors_prom or "dsst_compile_programs_count" not in text:
            raise AssertionError(f"(21) prometheus: {st} {errors_prom[:5]}")
        st, _, doc = _http(http_port, "/trace?format=perfetto")
        errors_trace = traceck.check(doc) if st == 200 else [f"status {st}"]
        if errors_trace or not any(e.get("name") == "compile" for e in doc["traceEvents"]):
            raise AssertionError(f"(21) perfetto: {errors_trace[:5]}")
        log(f"[21] (d) /metrics?format=prometheus promck-clean ({len(text.splitlines())} lines); "
            f"/trace?format=perfetto traceck-clean ({len(doc['traceEvents'])} events, the "
            f"compile events among them)")
        _sync(on_card)
        launches = {"K2": cuda_step.fused_rounds_cuda.launches,
                    "K1": cuda_propagate.propagate_fixpoint_cuda.launches,
                    "K3": cuda_cover.cover_fused_rounds_cuda.launches}
        if min(launches.values()) <= 0:
            raise AssertionError(f"(21) a kernel of the phase never launched: {launches}")
        out["routes"] = routes
        out["launches"] = launches
    finally:
        if smoke_build is not None:
            smoke_build.kill()
            smoke_build.wait()
        cli.make_engine = make_engine
        stop.set()
        node.join(60)
        if api_c is not None:
            api_c.stop()
        if eng_c is not None:
            eng_c.stop(timeout=10)
        # --trace installed a recorder and a critical-path monitor for the
        # node's life; the later phases run without them.
        trace.install(None)
        critpath.install(None)
    if node.is_alive() or errors:
        raise AssertionError(f"(21) the node did not stop cleanly: {errors}")
    if compilewatch.active() is not None:
        raise AssertionError("(21) cli.main left its compile watch installed")
    # (e) The analysis runner over this checkout: the five AST rules in a
    # process that must not import torch, then the kernel lane (the
    # libraries' digests against the committed golden, the dtypes).
    code = ("import sys\n"
            "from distributed_sudoku_solver_tpu_torch.analysis.__main__ import main\n"
            "rc = main(['--strict-waivers'])\n"
            "assert 'torch' not in sys.modules, 'the AST lane imported torch'\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    ast_lane = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=300)
    ast_s = time.perf_counter() - t0
    kernel_lane = subprocess.run(
        [sys.executable, "-m", "distributed_sudoku_solver_tpu_torch.analysis", "--rule",
         "kernelck"], cwd=REPO, capture_output=True, text=True, timeout=300)
    for name, proc in (("AST lane", ast_lane), ("kernelck", kernel_lane)):
        if proc.returncode != 0:
            raise AssertionError(f"(21) (e) analysis {name}: rc {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out["analysis"] = {"ast_lane": ast_lane.stdout.strip().splitlines()[-1],
                       "ast_lane_s": ast_s,
                       "kernelck": kernel_lane.stdout.strip().splitlines()[-1]}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"[21] (e) analysis: {out['analysis']['ast_lane']} in {ast_s:.2f} s, no torch "
        f"imported; kernelck: {out['analysis']['kernelck']}")
    log(f"[21] {device['smi']}; phase wall {out['phase_wall_s']:.1f} s")
    log(json.dumps({"compile": out}, default=str))
    return launches, out["time_to_serving"], out["smoke_build"]


def kernel_row(key: str, suffix: str = "", **fields) -> dict:
    name, source, replaces = {**KERNELS, **PORT_KERNELS}[key]
    return dict(name=name + suffix, route="cuda",
                source=f"distributed_sudoku_solver_tpu_torch/csrc/{source}",
                replaces=replaces, library_ms=None, **fields)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="phases 1-3 and K2's and K3's stage breakdowns only (no result line)")
    ap.add_argument("--times", action="store_true",
                    help="phases 1 and 3 and the kernels' device times only (no result line); "
                         "runs against the checkout that holds this copy of the script")
    ap.add_argument("--bulk", action="store_true",
                    help="phases 1 and 3 and bulk passes at inflight 3, 1, 1, 3 only (no result "
                         "line); runs against the checkout that holds this copy of the script")
    ap.add_argument("--chunk-syncs", action="store_true",
                    help="phase 1 and the host syncs and wall per status chunk of the fused and "
                         "composite advances only (no result line); runs against the checkout "
                         "that holds this copy of the script")
    ap.add_argument("--serving", action="store_true",
                    help="phases 1-3, 12 (for the corpus's hardest boards) and the serving "
                         "phase only (no result line)")
    ap.add_argument("--frontdoor", action="store_true",
                    help="phases 1-3 and the front-door phase (18) only (no result line)")
    ap.add_argument("--cluster", action="store_true",
                    help="phases 1-3 and the cluster phase (19) only (no result line)")
    ap.add_argument("--mesh", action="store_true",
                    help="phases 1-3 and the mesh phase (20) only (no result line)")
    ap.add_argument("--compile", action="store_true",
                    help="phases 1-3 and the compile-watch phase (21) only (no result line)")
    ap.add_argument("--procmesh", action="store_true",
                    help="phases 1-3, the mesh phase (20) and the process-mesh phase (22) only "
                         "(no result line)")
    ap.add_argument("--probes", action="store_true",
                    help="phase 1, the two probe libraries' build and phases 15 and 16 only (no "
                         "result line); runs against the checkout that holds this copy of the "
                         "script")
    ap.add_argument("--procmesh-worker", nargs=4, metavar=("RANK", "WORLD", "WORKDIR", "DEVICE"),
                    help="one worker process of phase 22 (the phase starts these itself)")
    args = ap.parse_args(argv)
    if args.procmesh_worker:
        sys.path.insert(0, REPO)
        rank, world, workdir, dev_type = args.procmesh_worker
        return procmesh_worker(int(rank), int(world), workdir, dev_type)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_propagate, cuda_step  # noqa: F401

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    device = phase_device()
    if args.probes:
        phase_build(PROBE_TARGETS, ("probe_uint16", "probe_cover"))
        p16 = phase_p16(SIZES, dev)
        pcv = phase_pcv(SIZES, dev)
        probe_sass()
        log(json.dumps({"probes": {**{f"P16 {w}": row for w, row in p16.items()}, "PCV": pcv},
                        "card": device["smi"]}))
        return 0
    if args.times:
        phase_times(phase_corpus(dict(SIZES, corpus=SIZES["k2_lanes"])), SIZES, dev)
        return 0
    if args.chunk_syncs:
        log(json.dumps({"chunk_syncs": chunk_syncs(dev), "card": device["smi"]}))
        return 0
    if args.bulk:
        corpus = phase_corpus(SIZES)
        bulk_pass(corpus, dev, 3)  # warm-up, the build included
        log(json.dumps({"bulk": bulk_turns(corpus, dev, (3, 1, 1, 3), tag="[bulk]")}))
        return 0
    if args.breakdown:
        phase_build()
        phase_breakdown(phase_corpus(dict(SIZES, corpus=SIZES["k2_lanes"])), SIZES, dev)
        phase_cover_breakdown(cover_frontiers(SIZES, dev), SIZES)
        return 0
    if args.serving or args.frontdoor or args.cluster or args.mesh or args.procmesh:
        phase_build()
    corpus = phase_corpus(SIZES)
    if args.serving:
        _, minrem_nodes = phase_heads_main(corpus, SIZES, dev)
        phase_serving(corpus, minrem_nodes, device, SIZES, dev)
        return 0
    if args.frontdoor:
        phase_frontdoor(corpus, device, SIZES, dev)
        return 0
    if args.cluster:
        phase_cluster(corpus, device, SIZES, dev)
        return 0
    if args.mesh:
        phase_mesh(corpus, device, SIZES, dev)
        return 0
    if args.procmesh:
        phase_procmesh(corpus, device, SIZES, dev, phase_mesh(corpus, device, SIZES, dev))
        return 0
    # Phase 21 runs first, on a process with no kernel library loaded: its
    # node builds and loads every library under its compile watch, and
    # phase 2 then reports ptxas's view of those builds.
    compile_launches, serving_s, smoke_build_s = phase_compile(corpus, device, SIZES, dev)
    phase_build()
    if args.compile:
        return 0
    k1 = phase_k1(corpus, SIZES, dev)
    k2 = phase_k2(corpus, SIZES, dev)
    phase_breakdown(corpus, SIZES, dev)
    main_launches = phase_main(corpus, dev)
    phase_profile(corpus, dev)
    comp_launches = phase_composite(corpus, SIZES, dev)
    frontiers = cover_frontiers(SIZES, dev)
    k3_err, k3_rows = phase_k3(frontiers, SIZES, dev)
    phase_cover_breakdown(frontiers, SIZES)
    del frontiers
    cover_launches, cover_bookkeep = phase_cover_main(dev)
    phase_cover_profile(dev)
    bookkeep = phase_bookkeep(SIZES, dev)
    phase_cover_composite(SIZES, dev)
    k2_heads = phase_k2_heads(corpus, SIZES, dev)
    head_launches, minrem_nodes = phase_heads_main(corpus, SIZES, dev)
    flight_launches, _ = phase_flight(corpus, minrem_nodes, SIZES, dev)
    head_launches["head:cw-slack"] += flight_launches
    phase_snapshot(corpus, SIZES, dev)
    p16 = phase_p16(SIZES, dev)
    pcv = phase_pcv(SIZES, dev)
    serving = phase_serving(corpus, minrem_nodes, device, SIZES, dev)
    frontdoor = phase_frontdoor(corpus, device, SIZES, dev)
    cluster = phase_cluster(corpus, device, SIZES, dev)
    mesh = phase_mesh(corpus, device, SIZES, dev)
    procmesh = phase_procmesh(corpus, device, SIZES, dev, mesh)
    log(f"[23] elapsed {time.perf_counter() - t_start:.1f} s; node F answered its first request "
        f"{serving_s['node_f_first_answer_s']:.1f} s after its start (K2's and the bookkeeping "
        f"kernel's libraries built and loaded on that request), node C its first in "
        f"{serving_s['node_c_first_request_s']:.1f} s (K1's); the smoke's build of the other "
        f"five libraries beside phase 21 took {max(smoke_build_s.values(), default=0.0):.1f} s")
    kernels = [
        kernel_row("K1", launches=comp_launches["K1"] + serving["K1"] + mesh["K1"]
                   + procmesh["K1"] + compile_launches["K1"], **k1),
        kernel_row("K2", launches=main_launches["K2"] + serving["K2"] + frontdoor["K2"]
                   + cluster["K2"] + mesh["K2"] + procmesh["K2"] + compile_launches["K2"], **k2),
        kernel_row("K3", launches=sum(cover_launches.values()) + mesh["K3"] + procmesh["K3"]
                   + compile_launches["K3"], max_abs_err=k3_err, **k3_rows["pentomino6x10"]),
        kernel_row("BK", launches=main_launches["BK"] + sum(cover_bookkeep.values()),
                   max_abs_err=0, **bookkeep),
    ]
    kernels += [kernel_row("K2", f" {rule}", launches=head_launches[rule], **k2_heads[rule])
                for rule in HEAD_RULES]
    kernels += [kernel_row("P16", f" {width}", **row) for width, row in p16.items()]
    kernels.append(kernel_row("PCV", **pcv))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
