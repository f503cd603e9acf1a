"""Node CLI of the PyTorch/CUDA port: the JAX package's ``cli.py`` with
the same flags and defaults.

``python -m distributed_sudoku_solver_tpu_torch -p 8000 -s 7000`` boots one
cluster node on the card (``-a host:port`` joins a ring through any member,
``--advertise-host`` names the address peers dial, ``-d`` is the
slow-node handicap in ms); ``python -m distributed_sudoku_solver_tpu_torch
solve-file boards.txt -o out.txt`` bulk-solves a file through the fused
round kernel.  Both run on CUDA and raise where there is none: there is no
``--device`` flag and no CPU fallback (``make_engine`` and ``main`` take a
``device=`` keyword for tests only).

The handicap is kept as a *slow-node simulator* for observing cluster load
balancing: an artificial per-job sleep in the host engine.  It never
touches the device path.

What does not carry over from the JAX CLI:

* its persistent XLA compilation cache: the port's kernels are built once
  per source hash into ``_build/`` by ``ops/cuda_build.py``;
* ``--sharded`` solves every batch with ``parallel.solve_batch_sharded``
  over ``parallel.default_mesh()`` (every visible card), with no resident
  or megastep flight, as in the JAX CLI; ``--mesh-devices N`` shards the
  resident flight over N cards (``serving/mesh_scheduler.py``);
* the compile watch and cost plane wait for the port's observability slice
  (ROADMAP A14): none is installed and ``/metrics`` has no ``compile`` or
  ``cost`` section.  ``--no-compile-watch`` is accepted; a non-default
  ``--compile-warmup``, ``--compile-rearm`` or ``--peak-gflops`` is refused;
* ``--profile-dir`` traces with ``torch.profiler``: a bounded
  ``--profile-secs`` window runs on a thread of its own
  (``utils/profiling.start_profile_window``), ``--profile-secs 0`` traces
  the node's whole life.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

from distributed_sudoku_solver_tpu_torch.cluster.node import ClusterConfig, ClusterNode
from distributed_sudoku_solver_tpu_torch.cluster.wire import parse_addr
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.propagate import RULE_TIERS
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.http import ApiServer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_sudoku_solver_tpu_torch",
        description=(
            "Distributed constraint-satisfaction node on an NVIDIA GPU "
            "(default command), or `solve-file` for offline bulk solving"
        ),
    )
    ap.add_argument("-p", "--http-port", type=int, default=8000)
    ap.add_argument("-s", "--p2p-port", type=int, default=7000)
    ap.add_argument("-a", "--anchor", type=str, default=None, help="host:port of any cluster member")
    ap.add_argument("-d", "--handicap", type=float, default=0, help="artificial per-job delay, ms (slow-node simulator)")
    ap.add_argument("--host", type=str, default="0.0.0.0", help="bind address")
    ap.add_argument(
        "--advertise-host",
        type=str,
        default=None,
        help="address peers dial (default: auto-detected routable IP)",
    )
    ap.add_argument("--lanes", type=int, default=0, help="frontier lanes (0 = auto)")
    ap.add_argument("--stack-slots", type=int, default=64)
    ap.add_argument(
        "--rules",
        choices=RULE_TIERS,
        default="basic",
        help="propagation strength (extended adds box-line reductions, "
        "subsets adds naked-subset eliminations)",
    )
    ap.add_argument(
        "--branch",
        choices=(
            "minrem", "first", "mixed", "minrem-desc",
            "head:minrem", "head:cw-slack", "head:mlp",
        ),
        default="minrem",
        help="branch heuristic (first = reference-order bit-exact DFS; "
        "minrem-desc = MRV with descending digit order, the portfolio "
        "mirror; head:* = scored branch heads, ops/ordering.py — "
        "head:minrem is bit-exact to minrem, head:cw-slack weights MRV "
        "by peer-unit slack, head:mlp is the trained prior from "
        "benchmarks/train_ordering.py)",
    )
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument(
        "--no-resident",
        action="store_true",
        help="disable the continuous-batching resident flight (serving/"
        "scheduler.py); /solve then never answers 429 and every job runs "
        "in a static flight",
    )
    ap.add_argument(
        "--resident-slots",
        type=int,
        default=16,
        help="resident job slots per geometry (concurrent jobs packed into "
        "one long-lived frontier)",
    )
    ap.add_argument(
        "--resident-gang",
        type=int,
        default=8,
        help="lanes per resident job slot (per-job speculation width)",
    )
    ap.add_argument(
        "--resident-queue",
        type=int,
        default=64,
        help="resident admission-queue bound; beyond it /solve answers "
        "429 + Retry-After",
    )
    ap.add_argument(
        "--mesh-devices",
        type=int,
        default=0,
        help="shard the resident flight's lane axis over N devices "
        "(serving/mesh_scheduler.py): slot pool and throughput scale "
        "with N; fewer visible devices serve single-device, counted as "
        "mesh_unfit.  0/1 = single-device resident flight",
    )
    ap.add_argument(
        "--latency-mode",
        action="store_true",
        help="serve every eligible /solve through the megastep tier "
        "(serving/megastep.py): the whole advance loop runs as one "
        "flight with one status fetch per request instead of one per "
        "chunk.  Per-request opt-in stays available via POST "
        "/solve?latency=1 without this flag",
    )
    ap.add_argument(
        "--megastep-chunks",
        type=int,
        default=64,
        help="megastep in-graph loop bound (flight step budget = "
        "chunk-steps x this); a board still holding work past it "
        "degrades to the chunked resident path",
    )
    ap.add_argument(
        "--no-frontdoor",
        action="store_true",
        help="bypass the front door (serving/frontdoor): no symmetry-"
        "canonical result cache, no propagation probe, no native "
        "routing — every /solve pays the direct engine path, as before "
        "round 17",
    )
    ap.add_argument(
        "--cache-entries",
        type=int,
        default=65536,
        help="front-door result-cache capacity (canonical entries; LRU "
        "beyond it).  An entry is one solved or proven-unsat orbit — "
        "every symmetry-equivalent resubmission answers from it",
    )
    ap.add_argument(
        "--easy-score",
        type=int,
        default=64,
        help="front-door difficulty threshold: boards whose post-"
        "propagation branching slack (sum of candidates-1 over undecided "
        "cells) is at or below this race the native DFS instead of "
        "paying a device dispatch",
    )
    ap.add_argument(
        "--learn-easy-score",
        type=str,
        default=None,
        metavar="TRACE",
        help="learn the --easy-score threshold from a recorded ordering "
        "trace (obs/ordertrace.py JSONL, recorded with --ordering-trace) "
        "instead of the fixed default: the route/wall outcomes in the "
        "trace pick the score cut that minimizes estimated total wall "
        "(serving/frontdoor/learn.py).  Falls back to --easy-score when "
        "the trace is too thin to price both routes",
    )
    ap.add_argument(
        "--ordering-trace",
        type=str,
        default=None,
        metavar="PATH",
        help="journal route outcomes + sampled grids to this JSONL file "
        "(obs/ordertrace.py) — the training input for "
        "benchmarks/train_ordering.py (the mlp branch head and the "
        "learned easy-score threshold).  Off by default: zero overhead "
        "when unset",
    )
    ap.add_argument(
        "--ordering-sample",
        type=int,
        default=8,
        metavar="K",
        help="with --ordering-trace, record every K-th resolved grid as "
        "a branch-example source (1 = every grid)",
    )
    ap.add_argument(
        "--fault-retries",
        type=int,
        default=3,
        help="per-job retry budget for transient device faults (OOM, "
        "preemption, runtime errors) before the job fails "
        "(serving/faults.py)",
    )
    ap.add_argument(
        "--rebuild-cooldown",
        type=float,
        default=0.25,
        help="seconds before a failed resident flight is rebuilt (its jobs "
        "are requeued, not errored)",
    )
    ap.add_argument(
        "--breaker-failures",
        type=int,
        default=3,
        help="consecutive resident rebuild failures that open the circuit "
        "breaker (admission then falls back to static flights)",
    )
    ap.add_argument(
        "--breaker-cooldown",
        type=float,
        default=2.0,
        help="seconds an open breaker waits before half-opening (the next "
        "admission probes a rebuild)",
    )
    ap.add_argument(
        "--sharded",
        action="store_true",
        help="shard lanes over all visible devices",
    )
    ap.add_argument("--heartbeat-s", type=float, default=1.0)
    ap.add_argument(
        "--part-deadline",
        type=float,
        default=0.0,
        help="seconds before a shed subtree part stuck on a wedged-but-"
        "alive peer is re-homed locally (0 = off: the failure detector "
        "covers real deaths, and a deep search can legitimately run long; "
        "see README 'Cluster failure semantics' for the false-death-vs-"
        "duplicated-work tradeoff)",
    )
    ap.add_argument(
        "--trace",
        action="store_true",
        help="enable the per-job flight-recorder trace plane (obs/trace.py): "
        "spans from HTTP accept through device chunks to resolution, "
        "served on GET /trace[/uuid] and GET /trace?format=perfetto, with "
        "automatic flight-recorder dumps on permanent faults and "
        "breaker-open transitions",
    )
    ap.add_argument(
        "--trace-ring",
        type=int,
        default=4096,
        help="flight-recorder ring size in spans (the recent past the "
        "trace endpoints and crash dumps can see)",
    )
    ap.add_argument(
        "--trace-dump",
        type=str,
        default=None,
        help="directory for automatic flight-recorder dumps "
        "(default: <tmpdir>/dsst-flightrec when --trace is on)",
    )
    ap.add_argument(
        "--no-compile-watch",
        action="store_true",
        help="accepted for compatibility: the port installs no compile "
        "watch yet (ROADMAP A14), so there is nothing to disable",
    )
    ap.add_argument(
        "--compile-warmup",
        type=float,
        default=300.0,
        help="compile-watch warmup seconds: the port has no compile watch "
        "yet (ROADMAP A14), so only the default is accepted",
    )
    ap.add_argument(
        "--compile-rearm",
        type=float,
        default=300.0,
        help="compile-watch re-arm seconds: only the default is accepted "
        "until ROADMAP A14",
    )
    ap.add_argument(
        "--peak-gflops",
        type=float,
        default=None,
        help="the cost plane's peak GFLOP/s: the port has no cost plane "
        "yet (ROADMAP A14), so it is refused",
    )
    ap.add_argument(
        "--critpath-slow-ms",
        type=float,
        default=0.0,
        help="slow-job watchdog threshold for per-job critical-path "
        "dumps (obs/critpath.py; needs --trace).  0 = derive from the "
        "--slo latency objectives (off when neither is set)",
    )
    ap.add_argument(
        "--slo",
        type=str,
        default=None,
        help="declarative service-level objectives (obs/slo.py), e.g. "
        '--slo "solve_p95_ms<=250,error_rate<=0.01" — windowed error-'
        "budget burn rates surface on GET /slo and /metrics, and a "
        "burn-rate threshold crossing triggers a flight-recorder dump "
        "(when --trace is on)",
    )
    ap.add_argument(
        "--slo-window",
        type=float,
        default=60.0,
        help="sliding window (seconds) for SLO burn-rate computation",
    )
    ap.add_argument(
        "--slo-burn",
        type=float,
        default=1.0,
        help="burn-rate threshold that flips an objective to burning "
        "(1.0 = consuming the error budget exactly at the sustained "
        "allowable rate)",
    )
    ap.add_argument(
        "--brownout",
        action="store_true",
        help="force the brownout controller on even without --slo "
        "(serving/brownout.py; queue/wait/floor signals still drive the "
        "ladder — there is just no burn signal).  With --slo the "
        "controller is on by default",
    )
    ap.add_argument(
        "--no-brownout",
        action="store_true",
        help="disable SLO-burn-driven load shedding: a burn crossing "
        "then only dumps the flight recorder, as before round 18",
    )
    ap.add_argument(
        "--brownout-enter",
        type=float,
        default=1.0,
        help="pressure (normalized: 1.0 = at the configured limit — max "
        "over SLO burn, resident queue fill, admission-wait p95, "
        "rpc-floor drift) at which the brownout ladder climbs one stage",
    )
    ap.add_argument(
        "--brownout-exit",
        type=float,
        default=0.5,
        help="pressure at or below which calm accrues; after "
        "--brownout-quiet continuous seconds of calm the ladder steps "
        "down one stage (must be < --brownout-enter: the hysteresis band)",
    )
    ap.add_argument(
        "--brownout-quiet",
        type=float,
        default=15.0,
        help="continuous calm (pressure <= --brownout-exit) before the "
        "brownout ladder de-escalates one stage",
    )
    ap.add_argument(
        "--journal-dir",
        type=str,
        default=None,
        help="durable job journal (serving/journal.py): every accepted "
        "/solve is WAL-logged here before the 201, unresolved entries "
        "replay through the normal submit path on restart (at-least-once "
        "with uuid dedupe), SIGTERM walks the drain ladder (finish / "
        "hand off to a healthy peer / journal) instead of dropping "
        "accepted work, and the front-door hot set persists beside the "
        "WAL.  Off by default: zero disk I/O when unset",
    )
    ap.add_argument(
        "--access-log",
        action="store_true",
        help="log one INFO record per HTTP request (logger "
        "distributed_sudoku_solver_tpu_torch.serving.http.access); previously "
        "access logging was silently swallowed",
    )
    ap.add_argument(
        "--profile-dir",
        type=str,
        default=None,
        help="capture a torch.profiler trace (host and device, Chrome-"
        "trace JSON) into this dir; bounded windows are also available "
        "at runtime via POST /profile",
    )
    ap.add_argument(
        "--profile-secs",
        type=float,
        default=60.0,
        help="bound the --profile-dir capture window (trace data grows "
        "unboundedly on a long-lived node; 0 = whole lifetime)",
    )
    sub = ap.add_subparsers(dest="cmd", metavar="{solve-file}")
    build_solve_file_parser(sub)
    return ap


# Compile-watch and cost-plane flags the port refuses until ROADMAP A14
# brings those planes over: (dest, flag, the JAX CLI's default).
_A14_FLAGS = (
    ("compile_warmup", "--compile-warmup", 300.0),
    ("compile_rearm", "--compile-rearm", 300.0),
    ("peak_gflops", "--peak-gflops", None),
)


def check_port_flags(ap: argparse.ArgumentParser, args) -> None:
    """Refuse, through ``ap.error``, what the port does not serve yet: a
    non-default compile-watch or cost-plane value (ROADMAP A14)."""
    for dest, flag, default in _A14_FLAGS:
        if getattr(args, dest) != default:
            ap.error(f"{flag} needs the port's compile watch and cost plane (ROADMAP A14)")


def make_engine(args, device=None) -> SolverEngine:
    """The node's engine from the parsed flags, on ``device`` (None: the
    card, and it raises without one)."""
    cfg = SolverConfig(
        lanes=args.lanes,
        stack_slots=args.stack_slots,
        rules=args.rules,
        branch=args.branch,
    )
    solve_fn = None
    if args.sharded:
        from distributed_sudoku_solver_tpu_torch.parallel import default_mesh, solve_batch_sharded

        mesh = default_mesh(device)
        solve_fn = lambda grids, geom, c: solve_batch_sharded(grids, geom, c, mesh=mesh)  # noqa: E731
    resident = None
    if not args.no_resident and solve_fn is None:
        # Continuous batching is on by default for serving nodes (the
        # sharded solve_fn keeps the one-call path, which has no flight
        # loop to host a resident frontier).
        from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig

        resident = ResidentConfig(
            job_slots=args.resident_slots,
            gang_lanes=args.resident_gang,
            queue_depth=args.resident_queue,
            mesh_devices=args.mesh_devices,
        )
    from distributed_sudoku_solver_tpu_torch.serving.faults import RecoveryPolicy

    frontdoor = None
    if not args.no_frontdoor:
        # The front door (serving/frontdoor) is the default routing layer
        # for POST /solve: canonical result cache, propagation probe,
        # native routing for the easy tier.
        from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import (
            FrontDoorConfig,
        )

        easy_score = args.easy_score
        if args.learn_easy_score:
            # The learned routing threshold: replayed route/wall outcomes
            # pick the cut; a too-thin trace keeps the flag default (the
            # learner says why).
            from distributed_sudoku_solver_tpu_torch.serving.frontdoor.learn import (
                learned_easy_score,
            )

            easy_score, report = learned_easy_score(
                args.learn_easy_score, default=args.easy_score
            )
            print(
                f"easy-score: {easy_score} "
                f"({'learned from ' + args.learn_easy_score if report.get('fitted') else report.get('reason', 'default')})"
            )
        frontdoor = FrontDoorConfig(
            cache_entries=args.cache_entries,
            easy_score=easy_score,
        )
    megastep = None
    if solve_fn is None:
        # The megastep config exists even when latency_mode is off: the
        # per-request /solve?latency=1 opt-in still routes here.  The
        # sharded solve_fn has no flight loop, so it excludes the megastep.
        from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig

        megastep = MegastepConfig(
            gang_lanes=args.resident_gang,
            max_chunks=args.megastep_chunks,
        )
    journal = None
    if args.journal_dir:
        # The WAL boots BEFORE the engine so the very first accepted job
        # is journaled; recovery replays after the cluster node joins
        # (main()).
        from distributed_sudoku_solver_tpu_torch.serving.journal import Journal

        journal = Journal(args.journal_dir)
    return SolverEngine(
        config=cfg,
        max_batch=args.max_batch,
        solve_fn=solve_fn,
        handicap_s=args.handicap / 1000.0,
        resident=resident,
        recovery=RecoveryPolicy(
            max_retries=args.fault_retries,
            rebuild_cooldown_s=args.rebuild_cooldown,
            breaker_failures=args.breaker_failures,
            breaker_cooldown_s=args.breaker_cooldown,
        ),
        frontdoor=frontdoor,
        latency_mode=args.latency_mode,
        megastep=megastep,
        journal=journal,
        device=device,
    )


def build_solve_file_parser(sub) -> argparse.ArgumentParser:
    desc = "Bulk-solve a puzzle file (one board per line / Kaggle CSV)"
    ap = sub.add_parser("solve-file", help=desc, description=desc)
    ap.add_argument("input", help="input board file")
    ap.add_argument("-o", "--output", default=None, help="write solutions (line-aligned)")
    ap.add_argument("-n", "--size", type=int, default=9, help="board size n (9/16/25)")
    ap.add_argument("--batch", type=int, default=65536, help="boards per device batch")
    ap.add_argument(
        "--rules",
        choices=RULE_TIERS,
        default="extended",
        help="propagation strength (extended adds box-line reductions, "
        "subsets adds naked-subset eliminations)",
    )
    return ap




def solve_file_main(args, device=None) -> None:
    """`solve-file` subcommand: bulk-solve a board file through ops/bulk.py
    on ``device`` (None: the card)."""
    import json

    from distributed_sudoku_solver_tpu_torch.models.geometry import geometry_for_size
    from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig
    from distributed_sudoku_solver_tpu_torch.utils import dataset

    geom = geometry_for_size(args.size)
    t0 = time.perf_counter()
    stats = dataset.solve_file(
        args.input,
        args.output,
        geom,
        batch=args.batch,
        bulk_config=BulkConfig(rules=args.rules),
        device=device,
    )
    stats["wall_s"] = round(time.perf_counter() - t0, 3)
    stats["boards_per_s"] = round(stats["total"] / max(stats["wall_s"], 1e-9), 1)
    print(json.dumps(stats))


def main(argv=None, *, device=None, stop: Optional[threading.Event] = None) -> None:
    """Run the command line.  ``device`` (None: the card) and ``stop`` (an
    event standing in for SIGTERM) are for tests that boot a node on the
    CPU in a thread of their own."""
    ap = build_parser()
    args = ap.parse_args(argv)
    check_port_flags(ap, args)
    if args.cmd == "solve-file":
        solve_file_main(args, device=device)
        return
    import contextlib

    from distributed_sudoku_solver_tpu_torch.utils.profiling import (
        device_trace,
        start_profile_window,
    )

    if args.access_log:
        # The access logger emits INFO records; logging's lastResort
        # handler only surfaces WARNING+ — give it a real stderr handler
        # so the flag actually produces output on an unconfigured process.
        import logging

        acc = logging.getLogger(
            "distributed_sudoku_solver_tpu_torch.serving.http.access"
        )
        if not acc.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(message)s")
            )
            acc.addHandler(handler)
            acc.setLevel(logging.INFO)
    if args.trace:
        import os
        import tempfile

        from distributed_sudoku_solver_tpu_torch.obs import critpath as critpath_mod
        from distributed_sudoku_solver_tpu_torch.obs import trace as trace_mod

        trace_mod.install(
            trace_mod.TraceRecorder(
                ring=args.trace_ring,
                dump_dir=args.trace_dump
                or os.path.join(tempfile.gettempdir(), "dsst-flightrec"),
            )
        )
        # Per-job critical-path attribution rides the trace plane (it
        # decomposes the recorder's stitched spans, so without --trace
        # there is nothing to attribute).  The slow-job threshold falls
        # back to the --slo latency objectives when not pinned here.
        critpath_mod.install(
            critpath_mod.CritPathMonitor(
                slow_ms=args.critpath_slow_ms or None
            )
        )
    if args.ordering_trace:
        # The opt-in ordering journal (obs/ordertrace.py): route outcomes
        # + sampled grids, the raw material for the offline branch-head
        # and threshold trainers.  Installed before the engine boots so
        # the warmup solves are journaled too.
        from distributed_sudoku_solver_tpu_torch.obs import (
            ordertrace as ordertrace_mod,
        )

        ordertrace_mod.install(
            ordertrace_mod.OrderTraceRecorder(
                args.ordering_trace, sample_grids=args.ordering_sample
            )
        )
    slo_monitor = None
    if args.slo:
        from distributed_sudoku_solver_tpu_torch.obs import slo as slo_mod

        # Parse before anything heavy boots: a typo in the grammar should
        # fail the command, not a node an hour into serving.
        slo_monitor = slo_mod.SloMonitor(
            slo_mod.parse_slo(args.slo),
            window_s=args.slo_window,
            burn_threshold=args.slo_burn,
        )
        slo_mod.install(slo_monitor)
    with contextlib.ExitStack() as stack:
        # A bounded window stops capture without stopping the node: torch's
        # profiler must stop on the thread that started it, so the window
        # runs on a thread of its own.  A lifetime trace (--profile-secs 0)
        # survives any exit path.
        if args.profile_dir and args.profile_secs > 0:
            start_profile_window(
                args.profile_dir,
                args.profile_secs,
                on_close=lambda: print(f"profile window closed ({args.profile_secs:g}s)"),
            )
        elif args.profile_dir:
            stack.enter_context(device_trace(args.profile_dir))
        engine = make_engine(args, device=device).start()
        if slo_monitor is not None:
            # Burn dumps embed a metrics snapshot; injected here because
            # obs/slo.py never imports the serving layer back.
            slo_monitor.metrics_fn = engine.metrics
        if not args.no_brownout and (args.brownout or args.slo):
            # Close the observability->control loop (serving/brownout.py):
            # on by default whenever --slo is set — a node that measures
            # its burn should act on it.  Bound post-boot because the
            # signal closures read the live engine (the slo metrics_fn
            # pattern above).
            from distributed_sudoku_solver_tpu_torch.serving import (
                brownout as brownout_mod,
            )

            ctrl = brownout_mod.BrownoutController(
                brownout_mod.BrownoutConfig(
                    enter=args.brownout_enter,
                    exit=args.brownout_exit,
                    quiet_s=args.brownout_quiet,
                )
            )
            brownout_mod.bind_engine(ctrl, engine)
            brownout_mod.install(ctrl)
        node = ClusterNode(
            engine,
            host=args.host,
            port=args.p2p_port,
            anchor=parse_addr(args.anchor) if args.anchor else None,
            config=ClusterConfig(
                heartbeat_s=args.heartbeat_s,
                part_deadline_s=args.part_deadline,
            ),
            advertise_host=args.advertise_host,
        ).start()
        api = ApiServer(
            node, host=args.host, port=args.http_port,
            access_log=args.access_log,
        ).start()
        print(
            f"node up: http={args.host}:{api.port} p2p={node.addr_s} "
            f"coordinator={node.coordinator}",
            flush=True,
        )
        if args.journal_dir:
            # Crash recovery AFTER the ring join: replayed jobs route
            # through the normal submit seam, exactly like fresh ones
            # (at-least-once; verdict dedupe makes the replay idempotent).
            n = node.recover()
            if n:
                print(f"journal: replayed {n} unresolved job(s)")
        import signal

        term = stop if stop is not None else threading.Event()
        if stop is None:
            try:
                # Orchestrators speak SIGTERM: flag it, drain on the main
                # thread below (signal handlers must stay trivial).
                signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
            except ValueError:
                pass  # not the main thread (embedded use): ^C still works
        try:
            while not term.wait(1.0):
                pass
            # Graceful stop: walk the drain ladder (finish in-flight work,
            # hand unstarted jobs to a healthy peer or journal them,
            # persist the front-door hot set, fsync the WAL) BEFORE
            # leaving the ring — an accepted job is never dropped.
            print("SIGTERM: draining...")
            print(f"drain: {node.drain()}", flush=True)
        except KeyboardInterrupt:
            print("stopping...")
        api.stop()
        node.stop()
        engine.stop()
        if engine.journal is not None:
            engine.journal.shutdown()


if __name__ == "__main__":
    main()
