"""Host-side job engine: a queue feeding chunked, batched device solves.

Port of the JAX package's ``serving/engine.py``, line for line where the
logic is host Python; only the device seams change.

* **submit** enqueues a uuid-tagged job and returns at once; callers wait
  on the job's ``threading.Event``.
* **the device loop** (one thread, the device's single owner) drains the
  queue into *flights*: a flight is one geometry-grouped batch of jobs
  sharing one frontier, advanced in bounded-step chunks
  (``utils.checkpoint.advance_frontier_status`` or
  ``ops.cuda_step.advance_frontier_fused_status``), several flights
  round-robin.  The loop keeps the JAX engine's order, **one dispatch
  ahead**: chunk k+1 is advanced before chunk k's packed status word, the
  chunk's one host fetch, is consumed.  Cancels, deadlines and resolution
  therefore react one chunk late.  Here the order buys no overlap yet:
  each advance reads its loop condition on the host before every K2 (or
  composite) dispatch, the first read waiting for chunk k to finish, so
  chunk k+1 does not run behind chunk k (the device-side loop of ROADMAP
  A8 removes those reads).
* **cancel** lands mid-flight: between chunks the loop purges cancelled
  jobs' lanes (``ops.frontier.purge_jobs``).
* **snapshot / shed**: between chunks the loop services control requests
  (a job's surviving subtree roots; bottom stack rows shed for a peer).
* **stats** mirrors the reference node's counters (``validations`` =
  branch nodes expanded, ``solved``).

Device seams against the JAX engine:

* every tensor lives on ``SolverEngine.device`` (``ops.solve.resolve_device``:
  CUDA, or raise, unless ``device="cpu"`` is passed);
* :func:`host_fetch` is the one device-to-host seam: several tensors cross
  in one transfer;
* JAX donates the frontier to each program; here the advances update the
  stack in place, so a failed dispatch leaves ``fl.state`` unusable and
  recovery always re-seeds from the jobs;
* host arrays reach the device through :func:`to_device` (pinned memory,
  an asynchronous copy on CUDA), so an upload between dispatches does not
  wait for the device.

With ``frontdoor=FrontDoorConfig()`` eligible submits cross the front door
(``serving/frontdoor``) first, as in the JAX engine: the canonical cache,
the propagation probe, the native race (``serving/portfolio.race_native``),
and only the hard tail reaches a device flight.

With ``ResidentConfig(mesh_devices=N > 1)`` the resident flight is the
mesh flight (``serving/mesh_scheduler.py``) over the first N devices that
``parallel.mesh.visible_devices`` gives; with fewer, the engine counts
``mesh_unfit`` and serves on one device.

With a compile watch installed (``obs/compilewatch.py``; the CLI installs
one by default) ``/metrics`` carries its ``compile`` section, and ``cost``
once a flight has been born: each flight prices its advance program once
per shape (``ops/cost.advance_round_cost``, host arithmetic on the shape),
and the device-efficiency gauge prices the rounds and walls of the static,
resident and megastep flights with it, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import uuid as uuid_mod
from typing import Any, Callable, Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry, geometry_for_size
from distributed_sudoku_solver_tpu_torch.obs import (
    compilewatch,
    critpath,
    lockdep,
    ordertrace,
    slo,
    trace,
)
from distributed_sudoku_solver_tpu_torch.obs.hist import LatencyHistogram, MinEstimator
from distributed_sudoku_solver_tpu_torch.obs.logctx import job_log, uuids_label
from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
from distributed_sudoku_solver_tpu_torch.ops.cost import advance_round_cost
from distributed_sudoku_solver_tpu_torch.ops.cuda_build import KernelError
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    SolverConfig,
    init_frontier_packed,
    init_frontier_roots,
    purge_jobs,
    shed_rows,
    unpack_status,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import _finalize, resolve_device, solve_batch
from distributed_sudoku_solver_tpu_torch.serving import brownout, faults
from distributed_sudoku_solver_tpu_torch.serving import journal as journal_wal
from distributed_sudoku_solver_tpu_torch.utils.profiling import StatWindow

_LOG = logging.getLogger(__name__)


def _tensors_to_host(tensors: list) -> list:
    """Copy tensors to host numpy in ONE device-to-host transfer: each is
    flattened to its bytes, the bytes are concatenated on its device, and
    the host splits them back into arrays of the original dtypes."""
    if not tensors:
        return []
    if len(tensors) == 1:
        return [tensors[0].detach().cpu().numpy()]
    flat = [t.detach().reshape(-1).contiguous().view(torch.uint8) for t in tensors]
    blob = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(blob[at : at + nbytes].copy().view(dtype).reshape(tuple(t.shape)))
        at += nbytes
    return out


def host_fetch(x, floor_s: float = 0.0, tag: str = "status"):
    """THE device->host value seam of the serving hot loops.

    Every value the engine's flight loop, the resident scheduler or a
    megastep flight reads off the device goes through here, which makes
    "exactly one host sync per chunk" enforceable: the fetch-count tests
    wrap this function.  ``floor_s`` simulates the per-sync floor of a
    slow link (the engine's ``handicap_s``), slept here, at the sync.
    ``tag`` classifies the sync: ``'status'`` (the one per-chunk fetch, or
    a megastep flight's one fetch), ``'event'`` (verdict data, only on
    chunks where a job resolved), ``'finalize'`` (terminal flight drain),
    ``'control'`` (snapshot and shed requests).  ``x`` is a tensor or a
    tuple / NamedTuple of tensors (other entries pass through); the result
    is the matching numpy tree, all tensors copied in one transfer."""
    faults.fire("fetch." + tag)
    if floor_s:
        # clockck: allow(simulated RPC floor: sleeping at the sync IS this seam's documented behavior)
        time.sleep(floor_s)
    if isinstance(x, torch.Tensor):
        return _tensors_to_host([x])[0]
    items = list(x)
    idx = [i for i, v in enumerate(items) if isinstance(v, torch.Tensor)]
    for i, arr in zip(idx, _tensors_to_host([items[i] for i in idx])):
        items[i] = arr
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: on CUDA
    the array is staged in pinned memory and copied asynchronously (a copy
    from pageable memory would first drain the stream).  The caching host
    allocator keeps the staging buffer until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))  # syncck: allow(the host-to-device direction: a is a host array by contract, made contiguous for from_numpy)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class Job:
    """One ``/solve`` request travelling through the engine."""

    uuid: str
    grid: np.ndarray
    geom: Geometry
    # A resumed/offloaded job re-enters as subtree roots (uint32 candidate
    # rows [R, h, w]) instead of a clue grid; `grid` is then unused.
    roots: Optional[np.ndarray] = None
    # Per-job solver-config override: jobs group into flights by
    # (geometry, config).  None = the engine default.
    config: Optional[SolverConfig] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    solution: Optional[np.ndarray] = None
    solved: bool = False
    unsat: bool = False
    nodes: int = 0
    sol_count: int = 0  # exact model count under count_all (then `unsat`
    #   means "enumeration complete" and `solution` is the first found)
    cancelled: bool = False
    # Rows shed to a peer leave the local search incomplete: local
    # exhaustion (`exhausted`) is then no proof of unsatisfiability.
    shed_parts: int = 0
    exhausted: bool = False
    error: Optional[str] = None
    # Absolute monotonic deadline, enforced at chunk granularity on the
    # resident and the static flight paths; None = no deadline on the
    # static path, the default deadline on resident admission.
    deadline: Optional[float] = None
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    # Recovery bookkeeping (serving/faults.py): retries charged, the last
    # fault's class, and the bisection group token that keeps requeued
    # halves of a permanently failing batch apart.
    fault_retries: int = 0
    last_fault: Optional[str] = None
    bisect_token: Optional[int] = None
    # Recorder-clock submit time (obs/trace.py), set only when tracing.
    trace_t0: Optional[float] = None
    # The front door's route ('cache' | 'propagation' | 'native' |
    # 'device'; None = never crossed it) and difficulty probe, journaled by
    # the ordering trace (obs/ordertrace.py); -1 = never probed.
    route: Optional[str] = None
    probe_score: int = -1
    probe_empties: int = -1
    # Resolution hook: called with the verdict fields set, BEFORE the done
    # event (the front door's cache fill: a waiter that resubmits the
    # moment it wakes must see the entry).  Fires at most once; its
    # exceptions are logged, never propagated.
    on_resolve: Optional[Callable[["Job"], None]] = None
    # Shadow jobs are accounting-invisible: resolution sets their verdict,
    # fires the hook and the done event, and touches no counter, histogram
    # or SLO sample.  The native race submits its device fallback as one,
    # so the user's one request is counted once, by the race's own hook.
    shadow: bool = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n (capped): one frontier shape per bucket."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return b


@dataclasses.dataclass
class _Flight:
    """One in-progress device batch: jobs sharing a frontier, advanced in chunks."""

    geom: Geometry
    config: SolverConfig
    jobs: list  # list[Job]; index in this list == job id on the device
    state: Frontier
    started: float = dataclasses.field(default_factory=time.monotonic)
    chunks: int = 0
    # The un-fetched status word of the most recent chunk, and the host's
    # view of the step counter as of the last consumed status.
    pending_status: Any = None
    steps_seen: int = 0


@dataclasses.dataclass
class _Control:
    """A cross-thread request the device loop services between chunks.

    Waiter and servicer both take ``lock``; whoever wins decides whether a
    timed-out request is abandoned (no-op) or was serviced (the waiter
    returns its result even after its timeout raced)."""

    kind: str  # 'snapshot' | 'shed' | 'exec'
    uuid: Optional[str] = None
    k: int = 8
    fn: Any = None  # 'exec': zero-arg callable run on the device-owner thread
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    lock: Any = dataclasses.field(  # lockck: name(serving.control)
        default_factory=lambda: lockdep.named_lock("serving.control")
    )
    abandoned: bool = False
    claimed: bool = False  # servicer took it; abandon is no longer possible
    result: Any = None
    error: Optional[str] = None  # servicer-side exception, for exec callers


class EngineDraining(RuntimeError):
    """Raised by ``submit`` once the drain ladder left ``serving``; the
    HTTP layer answers 503 + Retry-After."""

    def __init__(self, state: str, retry_after_s: float = 5.0):
        super().__init__(f"engine {state}: admission closed")
        self.state = state
        self.retry_after_s = retry_after_s


class SolverEngine:
    """Single-owner device loop consuming a thread-safe job queue."""

    def __init__(
        self,
        config: SolverConfig = SolverConfig(),
        max_batch: int = 256,
        batch_window_s: float = 0.002,
        solve_fn=None,
        chunk_steps: int = 64,
        max_flights: int = 4,
        handicap_s: float = 0.0,
        resident=None,  # Optional[serving.scheduler.ResidentConfig]
        recovery: Optional[faults.RecoveryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        frontdoor=None,
        latency_mode: bool = False,
        megastep=None,  # Optional[serving.megastep.MegastepConfig]
        journal=None,  # Optional[serving.journal.Journal]
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.chunk_steps = max(1, chunk_steps)
        self.max_flights = max(1, max_flights)
        # Slow-node simulator: charged per host sync at host_fetch.
        self.handicap_s = handicap_s
        self._clock = clock
        self._solve_fn = solve_fn or (
            lambda grids, geom, cfg: solve_batch(grids, geom, cfg, device=self.device)
        )
        self._use_flights = solve_fn is None
        self.latency = StatWindow()  # seconds per job
        self.batch_sizes = StatWindow()  # jobs per device batch
        self.chunk_wall = StatWindow()  # seconds per flight-loop pass
        # The overlap split: dispatch wall = host time in the advance
        # (in JAX asynchronous and near zero; here it includes the loop
        # condition's reads, ROADMAP A8); sync wall = host time blocked in
        # the one per-chunk status fetch; event wall = the rarer verdict
        # and finalize fetches.
        self.dispatch_wall = StatWindow()
        self.sync_wall = StatWindow()
        self.event_wall = StatWindow()
        self.hist = {
            k: LatencyHistogram()
            for k in (
                "latency_ms",
                "solve_ms",
                "dispatch_wall_ms",
                "sync_wall_ms",
                "event_wall_ms",
                "admission_wait_ms",
                "chunk_wall_ms",
                "frontdoor_cache_ms",
                "frontdoor_propagation_ms",
                "frontdoor_native_ms",
                "frontdoor_device_ms",
                # Whole-flight walls of latency-mode megastep flights, never
                # recorded into the per-chunk seams.
                "frontdoor_megastep_ms",
            )
        }
        self.rpc_floor = MinEstimator()  # per-sync minimum of chunk syncs
        self._chunk_wall_total = 0.0
        self._chunk_steps_total = 0
        self._queue: "queue.Queue[Job]" = queue.Queue()
        self._control: "queue.Queue[_Control]" = queue.Queue()
        self._flights: list[_Flight] = []  # owned by the device loop
        # Continuous batching (serving/scheduler.py): one resident flight
        # per geometry; ineligible jobs keep the static flight path.
        self.resident_config = resident
        self._resident: dict = {}  # Geometry -> ResidentFlight | None
        self.resident_unfit = 0  # lockck: guard(_lock)
        self.mesh_unfit = 0  # lockck: guard(_lock)
        # Latency-mode megastep (serving/megastep.py): one flight per
        # eligible submit, on the submitting thread.
        self.latency_mode = bool(latency_mode)
        self.megastep_config = megastep
        self._megasteps: dict = {}  # Geometry -> MegastepFlight | None
        self.megastep_unfit = 0  # lockck: guard(_lock)
        self._cancelled: "dict[str, None]" = {}  # insertion-ordered, bounded
        self._lock = lockdep.named_lock("serving.engine")  # lockck: name(serving.engine)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Guarded: megastep flights resolve jobs on submit threads.
        self.validations = 0  # lockck: guard(_lock)
        self.solved_count = 0  # lockck: guard(_lock)
        self.jobs_done = 0  # lockck: guard(_lock)
        # Fused flights downgraded to the composite step at launch (see
        # _fit_fused).
        self.fused_downgrades = 0
        # Recovery counters (serving/faults.py), single-writer on the loop
        # except fault_bulk_retries (HTTP bulk threads).
        self.recovery = recovery or faults.RecoveryPolicy()
        self.fault_retries_total = 0
        self.fault_requeues = 0
        self.fault_downgrades_fused = 0
        self.fault_lane_halvings = 0
        self.fault_bisections = 0
        self.fault_budget_exhausted = 0
        self.fault_permanent = 0
        self.fault_bulk_retries = 0  # lockck: guard(_lock)
        self._bisect_seq = 0
        # Lane occupancy of fused dispatches: deciles of each lane's live
        # rounds over the rounds its chunk advanced, from the status word.
        self._occ_hist = np.zeros(10, np.int64)
        self._occ_frac_sum = 0.0
        self._occ_chunks = 0
        # Durable job lifecycle (serving/journal.py).
        self.journal = journal
        self._lifecycle = "serving"  # lockck: guard(_lock)
        self.drain_handoffs = 0  # lockck: guard(_lock)
        self.drain_journaled = 0  # lockck: guard(_lock)
        self.drain_finished = 0  # lockck: guard(_lock)
        self.recovered_jobs = 0  # lockck: guard(_lock)
        self._drain_wait = threading.Event()  # never set: drain's pacing timer
        # Idempotent-resubmit registry (insertion-ordered, bounded).
        self._jobs_by_uuid: "dict[str, Job]" = {}  # lockck: guard(_lock)
        self.trace_node: Optional[str] = None
        # The front door (serving/frontdoor): built last, so it sees a
        # fully wired engine (it probes native.available() once, here).
        self.frontdoor = None
        if frontdoor is not None:
            from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import FrontDoor

            self.frontdoor = FrontDoor(self, frontdoor)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SolverEngine":
        self._thread = threading.Thread(target=self._run, daemon=True, name="device-loop")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # A producer that won the lock before this drain is swept here; one
        # that arrives after saw _stop and raised in submit().
        with self._lock:
            self._drain_on_stop()

    # -- durable lifecycle (serving/journal.py) ------------------------------
    def _journal(self):
        return self.journal if self.journal is not None else journal_wal.active()

    def _dup_job(self, job_uuid: str) -> Optional[Job]:
        """Idempotency lookup: the live or real-verdict Job for a
        resubmitted uuid, or None (an error terminal is evicted here)."""
        with self._lock:
            prev = self._jobs_by_uuid.get(job_uuid)
            if prev is None:
                return None
            if prev.done.is_set() and prev.error is not None:
                self._jobs_by_uuid.pop(job_uuid, None)
                return None
            return prev

    def _journal_resolved(self, job: Job) -> None:
        """Discharge the job's WAL entry on a real verdict; error terminals
        stay accepted-only (replayed by ``recover``)."""
        if job.shadow:
            return
        if job.error is not None:
            with self._lock:
                self._jobs_by_uuid.pop(job.uuid, None)
            return
        jr = self._journal()
        if jr is not None:
            jr.record_resolved(
                job.uuid,
                {
                    "solved": bool(job.solved),
                    "unsat": bool(job.unsat),
                    "cancelled": bool(job.cancelled),
                    "exhausted": bool(job.exhausted),
                    "nodes": int(job.nodes),
                },
            )

    def recover(self) -> int:
        """Boot-time journal replay: re-submit every accepted entry with no
        resolution through the normal submit seam (front door included),
        after warming the front door's cache from the drain-time snapshot.
        Returns the number of jobs replayed."""
        jr = self._journal()
        if jr is None:
            return 0
        if self.frontdoor is not None:
            warmed = self.frontdoor.cache.import_hot(jr.load_frontdoor())
            if warmed:
                _LOG.info("[engine] front-door cache restored warm: %d entries", warmed)
        n = 0
        for ev in jr.unresolved():
            grid = ev.get("grid")
            if grid is None:
                continue
            try:
                cfg = SolverConfig(**ev["config"]) if ev.get("config") else None
                self.submit(
                    grid, job_uuid=ev.get("uuid"), config=cfg,
                    deadline_s=ev.get("deadline_s"),
                )
                n += 1
            except Exception as e:  # noqa: BLE001 - one bad entry must not sink the rest
                _LOG.error("[engine] journal replay failed for %s: %r", ev.get("uuid"), e)
        if n:
            with self._lock:
                self.recovered_jobs += n
            jr.mark_recovered(n)
            rec = trace.active()
            if rec is not None:
                rec.event(None, "journal.recover", "engine.lifecycle",
                          node=self.trace_node, jobs=n)
                rec.dump("journal_recovery", metrics=self.metrics())
        return n

    def drain(self, timeout: float = 30.0, handoff=None) -> dict:
        """Graceful drain: serving -> draining -> drained.  New submits
        raise :class:`EngineDraining`; unstarted work is offered to
        ``handoff`` or left to the journal's replay; in-flight flights
        finish (bounded by ``timeout``); the front door's hot cache entries
        persist beside the WAL and the journal syncs.  Idempotent.
        Returns the ``/admin/drain`` body."""
        with self._lock:
            if self._lifecycle != "serving":
                return {"state": self._lifecycle, "already_draining": True}
            self._lifecycle = "draining"
        started = self.busy_depth()
        rec = trace.active()
        if rec is not None:
            rec.event(None, "drain.begin", "engine.lifecycle",
                      node=self.trace_node, busy=started)
        jr = self._journal()
        detached: list[Job] = []
        while True:
            try:
                j = self._queue.get_nowait()
            except queue.Empty:
                break
            if not j.done.is_set():
                detached.append(j)
        for rf in self._resident_flights():
            detached.extend(rf.detach_pending())
        handoffs = journaled = 0
        for j in detached:
            shipped = False
            if handoff is not None and not j.shadow and j.roots is None:
                try:
                    shipped = bool(handoff(j))
                except Exception:  # noqa: BLE001 - a dead peer must not sink the drain
                    _LOG.exception("[engine] drain handoff failed for %s", j.uuid)
            if shipped:
                handoffs += 1
                if jr is not None and not j.shadow:
                    jr.record_resolved(j.uuid, {"handoff": True})
                j.error = "draining: handed off to peer"
            else:
                journaled += 1
                j.error = "draining: journaled for restart"
            j.done.set()
        # Spin-count pacing, so an injected clock cannot hang the drain.
        spins = max(1, int(timeout / 0.02))
        while spins > 0 and self.busy_depth() > 0:
            spins -= 1
            self._drain_wait.wait(0.02)
        leftover = self.busy_depth()
        if jr is not None:
            if self.frontdoor is not None:
                jr.save_frontdoor(self.frontdoor.cache.export_hot())
            jr.sync_now()
        finished = max(0, started - len(detached) - leftover)
        with self._lock:
            self._lifecycle = "drained"
            self.drain_handoffs += handoffs
            self.drain_journaled += journaled
            self.drain_finished += finished
        if rec is not None:
            rec.event(None, "drain.done", "engine.lifecycle", node=self.trace_node,
                      handoffs=handoffs, journaled=journaled, finished=finished,
                      leftover=leftover)
        return {
            "state": "drained",
            "handoffs": handoffs,
            "journaled": journaled,
            "finished": finished,
            "leftover": leftover,
        }

    # -- client API ----------------------------------------------------------
    def submit(
        self,
        grid,
        geom: Optional[Geometry] = None,
        job_uuid: Optional[str] = None,
        config: Optional[SolverConfig] = None,
        deadline_s: Optional[float] = None,
        saturation: str = "fallback",
        frontdoor: bool = True,
        shadow: bool = False,
        latency: Optional[bool] = None,
    ) -> Job:
        """Enqueue one job.

        With a front door installed (``SolverEngine(frontdoor=...)``),
        eligible jobs cross it first: cache hits and propagation verdicts
        come back resolved, easy boards race the native DFS
        (``serving/portfolio.race_native``), and only the hard tail reaches
        a device flight.  ``frontdoor=False`` is the per-call bypass (the
        race's own fallback, ``/solve_batch`` stragglers); per-job configs
        (portfolio racers, ``count_all``) skip it by construction.
        ``shadow`` submits an accounting-invisible job (see ``Job.shadow``).

        Eligible device-path jobs (no per-job config, no roots, engine not
        enumerating) route into the geometry's resident flight when one is
        configured; the rest take the static flight path.  ``saturation``
        picks the policy when the resident admission queue is full:
        ``'fallback'`` uses a static flight, ``'reject'`` raises
        ``EngineSaturated`` (HTTP 429 + Retry-After).  ``latency`` opts
        this submit into the megastep (``None`` defers to the engine's
        ``latency_mode``): the job is served on the caller's thread, and a
        megastep that cannot serve it degrades to the chunked paths."""
        g = np.asarray(grid, dtype=np.int32)  # syncck: allow(client input coercion at submit time — list/ndarray host data, not the hot loop)
        geom = geom or geometry_for_size(g.shape[0])
        if g.shape != (geom.n, geom.n):
            raise ValueError(f"grid shape {g.shape} does not match geometry {geom}")
        if job_uuid is not None and not shadow:
            prev = self._dup_job(job_uuid)
            if prev is not None:
                return prev
        if not shadow:
            with self._lock:
                if self._lifecycle != "serving":
                    raise EngineDraining(self._lifecycle)
        job = Job(uuid=job_uuid or str(uuid_mod.uuid4()), grid=g, geom=geom, config=config,
                  shadow=shadow)
        job.submitted_at = self._clock()
        rec = trace.active()
        if rec is not None:
            job.trace_t0 = rec.now()
        if deadline_s is not None:
            job.deadline = job.submitted_at + deadline_s
        # The WAL promise: `accepted` is on record before any routing, and
        # therefore before the client's 201.
        jr = None if shadow else self._journal()
        if jr is not None:
            jr.record_accepted(
                job.uuid, grid=g,
                config=dataclasses.asdict(config) if config is not None else None,
                deadline_s=deadline_s, geom=f"{geom.n}x{geom.n}",
            )
        if not shadow:
            with self._lock:
                self._jobs_by_uuid[job.uuid] = job
                while len(self._jobs_by_uuid) > 8192:
                    self._jobs_by_uuid.pop(next(iter(self._jobs_by_uuid)))
        try:
            fd_token = None
            fd_routed = False
            if (
                frontdoor
                and self.frontdoor is not None
                and config is None
                and not self.config.count_all
                and not shadow  # the race's fallback must not re-enter the door
            ):
                # The front door owns cache, propagation and native
                # verdicts; owned=False is the hard tail, whose routing is
                # committed (counters, cache-fill hook) only once placement
                # below succeeded, so a 429 inflates nothing.
                owned, fd_token = self.frontdoor.route(job, saturation=saturation)
                if owned:
                    return job
                fd_routed = True
            if self._megastep_eligible(job, latency):
                # The megastep resolves on this thread: the cache-fill hook
                # must be in place before it runs.
                if fd_routed:
                    self.frontdoor.commit_device(job, fd_token)
                    fd_routed = False
                if self._route_megastep(job):
                    return job
            if not self._route_resident(job, saturation):
                self._enqueue(job)
            if fd_routed:
                self.frontdoor.commit_device(job, fd_token)
            return job
        except BaseException:
            # Placement failed: the client gets an error, not a 201.
            if not shadow:
                with self._lock:
                    self._jobs_by_uuid.pop(job.uuid, None)
            if jr is not None:
                jr.record_resolved(job.uuid, {"cancelled": True, "rejected": True})
            raise

    def _route_resident(self, job: Job, saturation: str) -> bool:
        """True if the job was admitted to a resident flight."""
        if (
            self.resident_config is None
            or not self._use_flights
            or job.config is not None
            or job.roots is not None
            or self.config.count_all
        ):
            return False
        rf = self._resident_for(job.geom)
        if rf is None:
            return False
        verdict = rf.admit(job)
        if verdict == rf.ADMITTED:
            return True
        if verdict == rf.SATURATED and saturation == "reject":
            from distributed_sudoku_solver_tpu_torch.serving.scheduler import EngineSaturated

            raise EngineSaturated(rf.retry_after_s())
        # Saturated with quiet fallback, or DEFLECTED (breaker open /
        # flight closed, which is not client backpressure): static flight.
        return False

    def _megastep_eligible(self, job: Job, latency: Optional[bool]) -> bool:
        want = self.latency_mode if latency is None else bool(latency)
        return (
            want
            and self._use_flights
            and job.config is None
            and job.roots is None
            and not self.config.count_all
        )

    def _route_megastep(self, job: Job) -> bool:
        """True if the megastep resolved the job on this thread."""
        mf = self._megastep_for(job.geom)
        if mf is None:
            return False
        return mf.solve(job)

    def _megastep_for(self, geom: Geometry):
        """The geometry's megastep flight, built on the first eligible
        latency submit; None = unservable (cached)."""
        with self._lock:
            if self._stop.is_set():
                return None
            if geom in self._megasteps:
                return self._megasteps[geom]
            from distributed_sudoku_solver_tpu_torch.serving.megastep import (
                MegastepConfig,
                MegastepFlight,
            )

            try:
                mf = MegastepFlight(self, geom, self.megastep_config or MegastepConfig())
            except ValueError as e:
                self.megastep_unfit += 1
                self._megasteps[geom] = None
                _LOG.warning("[engine] megastep flight unfit for %s: %s", geom, e)
                return None
            self._megasteps[geom] = mf
            return mf

    def _resident_for(self, geom: Geometry):
        """The geometry's resident flight, built on the first eligible
        submit (host-side shape math only).  None = unservable: the caller
        falls back to static flights."""
        with self._lock:
            if self._stop.is_set():
                return None
            if geom in self._resident:
                return self._resident[geom]
            from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentFlight

            try:
                rf = None
                if self.resident_config.mesh_devices > 1:
                    # Shard the flight over a mesh (serving/mesh_scheduler.py).
                    # Too few visible devices degrade to the single-device
                    # flight, never to an error: the mesh is capacity, not
                    # correctness.  Only that ValueError is caught here.
                    from distributed_sudoku_solver_tpu_torch.serving.mesh_scheduler import (
                        MeshResidentFlight,
                    )

                    try:
                        rf = MeshResidentFlight(self, geom, self.resident_config)
                    except ValueError as e:
                        self.mesh_unfit += 1
                        _LOG.warning(
                            "[engine] mesh-resident flight unfit for %s "
                            "(single-device fallback): %s", geom, e,
                        )
                if rf is None:
                    rf = ResidentFlight(self, geom, self.resident_config)
            except ValueError as e:
                self.resident_unfit += 1
                self._resident[geom] = None
                _LOG.warning("[engine] resident flight unfit for %s: %s", geom, e)
                return None
            self._resident[geom] = rf
            return rf

    def job_is_resident(self, job_uuid: str) -> bool:
        """Whether a job is queued/running in a resident flight (resident
        jobs have no snapshot/shed surface — the cluster's progress loop
        skips them instead of polling a permanent None)."""
        for rf in self._resident_flights():
            with rf._lock:
                if any(j.uuid == job_uuid for j in rf._pending):
                    return True
            if any(j is not None and j.uuid == job_uuid for j in rf.slots):
                return True
        return False

    def _enqueue(self, job: Job) -> None:
        # Lock-ordered with stop()'s final drain.
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("engine stopped")
            self._queue.put(job)

    def submit_roots(
        self,
        roots,
        geom: Geometry,
        job_uuid: Optional[str] = None,
        config: Optional[SolverConfig] = None,
    ) -> Job:
        """Submit a job whose search space is given subtree roots (candidate
        rows uint32[R, h, w]): checkpoint resume and mid-job offload."""
        r = np.ascontiguousarray(np.asarray(roots, dtype=np.uint32))  # syncck: allow(resume payload coercion at submit time — wire-decoded host rows, not the hot loop)
        if r.ndim != 3 or r.shape[1:] != (geom.n, geom.n):
            raise ValueError(f"roots shape {r.shape} does not match geometry {geom}")
        if r.shape[0] == 0:
            raise ValueError("roots must contain at least one row")
        job = Job(
            uuid=job_uuid or str(uuid_mod.uuid4()),
            grid=np.zeros((geom.n, geom.n), np.int32),
            geom=geom, roots=r, config=config,
        )
        with self._lock:
            if self._lifecycle != "serving":
                raise EngineDraining(self._lifecycle)
        job.submitted_at = self._clock()
        rec = trace.active()
        if rec is not None:
            job.trace_t0 = rec.now()
        self._enqueue(job)
        return job

    def cancel(self, job_uuid: str) -> None:
        with self._lock:
            self._cancelled[job_uuid] = None
            while len(self._cancelled) > 4096:
                self._cancelled.pop(next(iter(self._cancelled)))

    def _request(self, req: _Control, timeout: float):
        with self._lock:
            if self._stop.is_set():
                return None
            self._control.put(req)
        if not req.done.wait(timeout):
            with req.lock:
                if not req.done.is_set() and not req.claimed:
                    req.abandoned = True  # servicer will no-op
                    return None
            # A running shed has already pulled rows: wait it out.
            if req.kind != "shed" and not req.done.is_set():
                return None
            req.done.wait()
        if req.error is not None and req.kind == "exec":
            raise RuntimeError(req.error)
        return req.result

    def snapshot_rows(self, job_uuid: str, timeout: float = 10.0):
        """Current surviving subtree roots of an in-flight job:
        ``(rows uint32[R, h, w], nodes, shed_parts, config dict)`` or None.
        Serviced between chunks, so the rows are a consistent frontier cut;
        ``shed_parts == 0`` proves they cover the job's remaining space."""
        return self._request(_Control(kind="snapshot", uuid=job_uuid), timeout)

    def shed_work(self, k: int = 8, timeout: float = 10.0):
        """Remove up to ``k`` bottom stack rows from the neediest in-flight
        job: ``(job_uuid, rows uint32[<=k, h, w], config dict)`` or None."""
        return self._request(_Control(kind="shed", k=max(1, k)), timeout)

    def run_exclusive(self, fn, timeout: float = 600.0):
        """Run ``fn()`` on the device-owner thread, between flight chunks.
        Returns its result, None if the loop never got to it within
        ``timeout``; raises RuntimeError if ``fn`` raised."""
        return self._request(_Control(kind="exec", fn=fn), timeout)

    def busy_depth(self) -> int:
        n = self._queue.qsize()
        for fl in list(self._flights):
            n += sum(0 if j.done.is_set() else 1 for j in fl.jobs)
        for rf in self._resident_flights():
            n += rf.queued_depth()
        return n

    def _resident_flights(self) -> list:
        with self._lock:
            return [rf for rf in self._resident.values() if rf is not None]

    def _megastep_flights(self) -> list:
        with self._lock:
            return [mf for mf in self._megasteps.values() if mf is not None]

    def stats(self) -> dict:
        s = {
            "validations": int(self.validations),
            "solved": int(self.solved_count),
            "jobs_done": int(self.jobs_done),
        }
        if self.frontdoor is not None:
            # Jobs the front door answered without a device flight count as
            # this node's work (native nodes land in `validations`).
            s = self.frontdoor.merge_stats(s)
        return s

    def metrics(self) -> dict:
        """Extended observability (GET /metrics)."""
        out = dict(self.stats())
        lat = self.latency.snapshot()
        if lat:
            out["job_latency_ms"] = {
                "count": lat["count"],
                **{k: round(lat[k] * 1e3, 3) for k in ("p50", "p95", "p99")},
            }
        bs = self.batch_sizes.snapshot()
        if bs:
            out["batch_jobs"] = {
                "count": bs["count"],
                **{k: round(bs[k], 1) for k in ("p50", "p95")},
            }
        for name, win in (
            ("chunk_wall_ms", self.chunk_wall),
            ("dispatch_wall_ms", self.dispatch_wall),
            ("sync_wall_ms", self.sync_wall),
            ("event_wall_ms", self.event_wall),
        ):
            snap = win.snapshot()
            if snap:
                out[name] = {
                    "count": snap["count"],
                    **{k: round(snap[k] * 1e3, 3) for k in ("p50", "p95")},
                }
        if self._chunk_steps_total > 0:
            out["step_wall_ms_avg"] = round(
                self._chunk_wall_total / self._chunk_steps_total * 1e3, 4
            )
        out["active_flights"] = len(self._flights)
        out["fused_downgrades"] = int(self.fused_downgrades)
        resident_flights = self._resident_flights()
        if resident_flights:
            out["resident"] = {
                f"{rf.geom.n}x{rf.geom.n}": rf.metrics() for rf in resident_flights
            }
        if self.resident_unfit:
            out["resident_unfit"] = int(self.resident_unfit)
        if self.mesh_unfit:
            out["mesh_unfit"] = int(self.mesh_unfit)
        megastep_flights = self._megastep_flights()
        if megastep_flights:
            out["megastep"] = {
                f"{mf.geom.n}x{mf.geom.n}": mf.metrics() for mf in megastep_flights
            }
        if self.megastep_unfit:
            out["megastep_unfit"] = int(self.megastep_unfit)
        if self.frontdoor is not None:
            # Cache, probe and route counters; the per-route latency
            # histograms ride the `hist` section below.
            out["frontdoor"] = self.frontdoor.metrics()
        fa = {
            "retries": int(self.fault_retries_total),
            "requeues": int(self.fault_requeues),
            "downgrades": {
                "fused_to_composite": int(self.fault_downgrades_fused),
                "lanes_halved": int(self.fault_lane_halvings),
            },
            "bisections": int(self.fault_bisections),
            "budget_exhausted": int(self.fault_budget_exhausted),
            "permanent_failures": int(self.fault_permanent),
            "bulk_retries": int(self.fault_bulk_retries),
        }
        breaker = {
            f"{rf.geom.n}x{rf.geom.n}": rf.breaker.metrics() for rf in resident_flights
        }
        if breaker:
            fa["breaker"] = breaker
        inj = faults.active()
        if inj is not None:
            fa["injector"] = inj.metrics()
        out["faults"] = fa
        rec = trace.active()
        if rec is not None:
            out["trace"] = rec.metrics()
        hist_sec = {k: h.to_dict() for k, h in self.hist.items() if len(h)}
        cp = critpath.active()
        if cp is not None:
            hist_sec.update(cp.hist_dicts())
            out["critpath"] = cp.metrics()
        if hist_sec:
            out["hist"] = hist_sec
        cw = compilewatch.active()
        if cw is not None:
            # The compile watch (obs/compilewatch.py): per-library builds,
            # first loads and walls, warmup/alarm state, and, once a flight
            # has priced its advance program, the cost plane with the live
            # device-efficiency gauge.
            out["compile"] = cw.metrics()
            cost = cw.cost_metrics()
            if cost is not None:
                # Rounds and walls from every serving loop: static chunks,
                # resident rounds, and megastep flights (whose wall is the
                # whole flight's, the only wall its one sync observes).
                rounds = self._chunk_steps_total
                wall = self._chunk_wall_total
                for rf in resident_flights:
                    rounds += rf.rounds_total
                    wall += rf.round_wall_total
                for mf in megastep_flights:
                    rounds += mf.rounds_total
                    wall += mf.round_wall_total
                eff = cw.efficiency(
                    compilewatch.ADVANCE_FUSED_STATUS
                    if self.config.step_impl == "fused"
                    else compilewatch.ADVANCE_STATUS,
                    rounds,
                    wall,
                )
                if eff is not None:
                    cost["efficiency"] = eff
                out["cost"] = cost
        floor = self.rpc_floor.to_dict()
        if floor is not None:
            out["rpc_floor_ms"] = floor
        mon = slo.active()
        if mon is not None:
            out["slo"] = mon.metrics()
        bo = brownout.active()
        if bo is not None:
            out["brownout"] = bo.metrics()
        jr = self._journal()
        if jr is not None:
            out["journal"] = jr.metrics()
        out["lifecycle"] = {
            "state": ("serving", "draining", "drained").index(self._lifecycle),
            "drain_handoffs": int(self.drain_handoffs),
            "drain_journaled": int(self.drain_journaled),
            "drain_finished": int(self.drain_finished),
            "recovered_jobs": int(self.recovered_jobs),
            "resubmit_registry": len(self._jobs_by_uuid),
        }
        if self._occ_chunks > 0:
            out["fused_lane_occupancy"] = {
                "bucket_pct": 10,
                "counts": [int(c) for c in self._occ_hist],
                "mean_pct": round(100.0 * self._occ_frac_sum / self._occ_chunks, 2),
                "chunks": int(self._occ_chunks),
            }
        return out

    # -- device loop ---------------------------------------------------------
    def _take_batch(self, wait: bool) -> list[Job]:
        try:
            first = self._queue.get(timeout=0.05 if wait else 0)
        except queue.Empty:
            return []
        jobs = [first]
        deadline = self._clock() + self.batch_window_s
        while len(jobs) < self.max_batch:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            try:
                jobs.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return jobs

    def _consume_cancel(self, job: Job) -> bool:
        with self._lock:
            return self._cancelled.pop(job.uuid, "absent") is None

    def _peek_cancels(self, jobs: list[Job]) -> list[int]:
        with self._lock:
            return [
                i for i, j in enumerate(jobs)
                if not j.done.is_set() and j.uuid in self._cancelled
            ]

    def _run(self) -> None:
        while not self._stop.is_set():
            resident = [rf for rf in self._resident_flights() if rf.active()]
            jobs = (
                self._take_batch(wait=not self._flights and not resident)
                if len(self._flights) < self.max_flights
                else []
            )
            live: list[Job] = []
            for job in jobs:
                if self._consume_cancel(job):
                    job.cancelled = True
                    self._journal_resolved(job)
                    job.done.set()
                else:
                    live.append(job)
            by_key: dict[tuple, list[Job]] = {}
            for job in live:
                by_key.setdefault(
                    (job.geom, job.config or self.config, job.bisect_token), []
                ).append(job)
            for (geom, cfg, _token), group in by_key.items():
                # The loop survives anything a batch throws: recover its
                # jobs and keep serving.
                try:
                    if self._use_flights:
                        self._launch_flights(geom, cfg, group)
                    else:
                        self._solve_group(geom, group, cfg)
                except Exception as e:  # noqa: BLE001
                    _LOG.error(
                        "[engine] batch failed (%s, %s): %r [%s]",
                        geom, uuids_label(group), e, faults.classify(e),
                    )
                    self._recover_group(group, cfg, e)
            self._service_controls()
            # A cooling resident flight with queued jobs is stepped too:
            # step() then only sweeps its queue (cancels, deadlines).
            stepable = list(resident)
            for rf in self._resident_flights():
                if rf not in stepable and rf.cooling() and rf.queued_depth():
                    stepable.append(rf)
            for rf in stepable:
                try:
                    rf.step()
                except Exception as e:  # noqa: BLE001
                    _LOG.error(
                        "[engine] resident flight failed (%s, %s): %r [%s]",
                        rf.geom, uuids_label([j for j in rf.slots if j is not None]),
                        e, faults.classify(e),
                    )
                    rf.on_failure(e)
            for fl in list(self._flights):
                try:
                    finished = self._advance_flight(fl)
                except Exception as e:  # noqa: BLE001
                    self._flights.remove(fl)
                    _LOG.error(
                        "[engine] flight failed (%s, %s): %r [%s]",
                        fl.geom, uuids_label(fl.jobs), e, faults.classify(e),
                    )
                    self._recover_jobs([j for j in fl.jobs if not j.done.is_set()],
                                       fl.config, e)
                    continue
                if finished:
                    self._flights.remove(fl)
        self._drain_on_stop()

    # -- fault recovery (serving/faults.py) -----------------------------------
    def _recover_group(self, group: list[Job], cfg, exc) -> None:
        """A batch failed at launch: recover every job no flight owns."""
        owned = {id(j) for fl in self._flights for j in fl.jobs}
        self._recover_jobs(
            [j for j in group if id(j) not in owned and not j.done.is_set()], cfg, exc
        )

    def _recover_jobs(self, jobs: list[Job], cfg: SolverConfig, exc) -> None:
        """Classify-and-recover for a failed dispatch's unresolved jobs.

        Transient: every job re-enters the queue under its retry budget,
        with the degraded config for the fault (fused -> composite; OOM ->
        halved lanes).  Permanent: a multi-job batch is bisected until the
        poison job fails alone, except on a ``KernelError`` (a kernel that
        cannot build, load or launch fails every job alike, so the batch
        fails at once and no rung falls back to a plain version).  The
        failed flight's state is never reused
        (its stack was updated in place by a dispatch that did not finish):
        a recovered job restarts from its grid or roots."""
        if not jobs:
            return
        kind = faults.classify(exc)
        label = f"{type(exc).__name__}: {exc}"
        rec = trace.active()
        if kind == faults.PERMANENT:
            if len(jobs) > 1 and not isinstance(exc, KernelError):
                self.fault_bisections += 1
                if rec is not None:
                    rec.event(None, "recovery.bisect", "engine.recovery",
                              node=self.trace_node, uuids=[j.uuid for j in jobs],
                              error=label)
                mid = len(jobs) // 2
                for half in (jobs[:mid], jobs[mid:]):
                    self._bisect_seq += 1
                    for job in half:
                        job.bisect_token = self._bisect_seq
                        job.last_fault = kind
                        self._requeue(job)
                _LOG.error(
                    "[engine] permanent batch failure (%s): bisecting %d jobs to "
                    "isolate the poison dispatch", uuids_label(jobs), len(jobs),
                )
            else:
                for job in jobs:
                    job.error = label
                    self.fault_permanent += 1
                    job_log(_LOG, job.uuid).error("[engine] permanent failure: %s", label)
                    if rec is not None:
                        rec.event(job.uuid, "fault.permanent", "engine.recovery",
                                  node=self.trace_node, error=label)
                    job.done.set()
                if rec is not None:
                    rec.dump("permanent_fault", metrics=self.metrics())
            return
        degraded = self._degrade(cfg, exc)
        for job in jobs:
            if not self._charge_retry(job, kind, label):
                continue
            if rec is not None:
                rec.event(job.uuid, "recovery.requeue", "engine.recovery",
                          node=self.trace_node, kind=kind, retry=job.fault_retries)
            # Pin the degraded config: the requeue groups under it and does
            # not re-enter the resident path.
            job.config = degraded
            self._requeue(job)

    def _charge_retry(self, job: Job, kind: str, label: str) -> bool:
        """Charge one transient retry against ``job``'s budget; False =
        exhausted (the job is failed and resolved here)."""
        job.fault_retries += 1
        job.last_fault = kind
        if job.fault_retries > self.recovery.max_retries:
            job.error = (
                f"retry budget exhausted after {job.fault_retries - 1} retries: {label}"
            )
            job.done.set()
            self.fault_budget_exhausted += 1
            job_log(_LOG, job.uuid).error("[engine] %s", job.error)
            rec = trace.active()
            if rec is not None:
                rec.event(job.uuid, "recovery.budget_exhausted", "engine.recovery",
                          node=self.trace_node, error=job.error)
            return False
        self.fault_retries_total += 1
        return True

    def _requeue(self, job: Job) -> None:
        # Device-loop thread only; _drain_on_stop sweeps the queue later.
        self._queue.put(job)
        self.fault_requeues += 1

    def _degrade(self, cfg: SolverConfig, exc) -> SolverConfig:
        """One rung down the fallback ladder for a transient retry: an OOM
        (``torch.cuda.OutOfMemoryError`` reads "CUDA out of memory")
        halves the flight's lane width, pinned so it caps every retried
        flight; any other transient fault on a fused config downgrades to
        the composite step.  A ``KernelError`` never reaches this ladder:
        it is permanent (``faults.classify``)."""
        rec = trace.active()
        if faults.is_oom(exc):
            lanes = cfg.lanes if cfg.lanes > 0 else cfg.min_lanes
            halved = max(1, lanes // 2)
            self.fault_lane_halvings += 1
            if rec is not None:
                rec.event(None, "recovery.downgrade", "engine.recovery",
                          node=self.trace_node, rung="lanes_halved", lanes=halved)
            new = dataclasses.replace(cfg, lanes=halved, min_lanes=min(cfg.min_lanes, halved))
            if new.steal_gang > 0 and halved % new.steal_gang:
                new = dataclasses.replace(new, steal_gang=0)
            return new
        if cfg.step_impl == "fused":
            self.fault_downgrades_fused += 1
            if rec is not None:
                rec.event(None, "recovery.downgrade", "engine.recovery",
                          node=self.trace_node, rung="fused_to_composite")
            return dataclasses.replace(cfg, step_impl="xla")
        return cfg

    def _drain_on_stop(self) -> None:
        """Resolve everything still pending when the loop exits."""
        leftovers: list[Job] = []
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for fl in self._flights:
            leftovers.extend(j for j in fl.jobs if not j.done.is_set())
        self._flights.clear()
        # stop() calls this with _lock held: a raw dict read, no helper.
        for rf in list(self._resident.values()):
            if rf is not None:
                rf.drain()
        for job in leftovers:
            if not job.done.is_set():
                job.error = "engine stopped"
                job.done.set()
        while True:
            try:
                req = self._control.get_nowait()
            except queue.Empty:
                break
            req.done.set()

    # -- flight path (default) ----------------------------------------------
    def _fit_fused(self, geom: Geometry, cfg: SolverConfig, would_be_lanes: int):
        """Pin a fused flight's lane count to a kernel-valid width
        (``ops.cuda_step.fused_lanes``), or downgrade the flight to the
        composite step when none fits (counted as ``fused_downgrades``)."""
        if cfg.step_impl != "fused":
            return cfg
        from distributed_sudoku_solver_tpu_torch.ops.cuda_step import fused_lanes

        try:
            return dataclasses.replace(
                cfg, lanes=fused_lanes(would_be_lanes, geom.n, cfg.stack_slots)
            )
        except ValueError as e:
            self.fused_downgrades += 1
            _LOG.warning("[engine] fused config unfit, downgrading to composite: %s", e)
            return dataclasses.replace(cfg, step_impl="xla")

    def _launch_flights(self, geom: Geometry, cfg: SolverConfig, group: list[Job]) -> None:
        cap = cfg.lanes if cfg.lanes > 0 else self.max_batch
        if cfg.step_impl == "fused":
            # Split the group at the widest width K2 serves, and clamp a
            # pinned width above it (JAX's logic; K2's cap is far wider
            # than a flight, see ops.cuda_step.max_fused_lanes).
            from distributed_sudoku_solver_tpu_torch.ops.cuda_step import max_fused_lanes

            mfl = max_fused_lanes(geom.n, cfg.stack_slots)
            if mfl > 0:
                cap = min(cap, mfl)
                if cfg.lanes > mfl or cfg.min_lanes > mfl:
                    cfg = dataclasses.replace(
                        cfg,
                        lanes=min(cfg.lanes, mfl) if cfg.lanes > 0 else 0,
                        min_lanes=min(cfg.min_lanes, mfl),
                    )
        # Roots jobs fly solo with packed seeding, at the configured width.
        for job in group:
            if job.roots is not None:
                self._start_packed_flight(geom, cfg, job)
        group = [j for j in group if j.roots is None]
        for i in range(0, len(group), cap):
            self._start_flight(geom, cfg, group[i : i + cap])

    def _start_packed_flight(self, geom: Geometry, cfg: SolverConfig, job: Job) -> None:
        r = job.roots
        bucket = _bucket(len(r), 1 << 30)
        if cfg.lanes > 0:
            # Cap padding at frontier capacity (R itself still fits).
            capacity = cfg.lanes * (1 + cfg.stack_slots)
            bucket = min(bucket, max(capacity, len(r)))
        roots = np.zeros((bucket, geom.n, geom.n), np.uint32)
        roots[: len(r)] = r
        valid = np.arange(bucket) < len(r)
        cfg = self._fit_fused(geom, cfg, cfg.resolve_lanes_packed(bucket))
        rec = trace.active()
        if rec is not None:
            rec.record(
                job.uuid, "admission", "engine.launch",
                t0=job.trace_t0 if job.trace_t0 is not None else rec.now(),
                node=self.trace_node, route="static", roots=len(r),
            )
        if faults.active() is not None:
            faults.fire("engine.launch", uuids=(job.uuid,))
        state = init_frontier_packed(
            to_device(roots.view(np.int32), self.device), to_device(valid, self.device), cfg
        )
        self._flights.append(_Flight(geom=geom, config=cfg, jobs=[job], state=state))

    def _start_flight(self, geom: Geometry, cfg: SolverConfig, jobs: list[Job]) -> None:
        """Grid jobs only (roots jobs fly packed): one root per job."""
        n = geom.n
        bucket = _bucket(len(jobs), max(self.max_batch, len(jobs)))
        if cfg.lanes > 0:
            bucket = min(bucket, cfg.lanes)  # a fixed lane count is a hard cap
        grids = np.zeros((bucket, n, n), np.int32)
        grids[: len(jobs)] = np.stack([job.grid for job in jobs])
        job_of_root = np.full(bucket, -1, np.int32)
        job_of_root[: len(jobs)] = np.arange(len(jobs), dtype=np.int32)
        cfg = self._fit_fused(geom, cfg, cfg.resolve_lanes(bucket))
        rec = trace.active()
        if rec is not None:
            now = rec.now()
            for job in jobs:
                rec.record(
                    job.uuid, "admission", "engine.launch",
                    t0=job.trace_t0 if job.trace_t0 is not None else now,
                    t1=now, node=self.trace_node, route="static",
                    config_override=job.config is not None,
                )
        if faults.active() is not None:
            faults.fire("engine.launch", uuids=tuple(j.uuid for j in jobs))
        # Padding rows are never seeded (job -1), so their encoding is moot.
        roots = encode_grid(to_device(grids, self.device), geom)
        state = init_frontier_roots(roots, to_device(job_of_root, self.device), bucket, cfg)
        self._flights.append(_Flight(geom=geom, config=cfg, jobs=jobs, state=state))

    def _advance_flight(self, fl: _Flight) -> bool:
        """One pipelined flight-loop pass; True when the flight is done.

        Every pass advances chunk k+1 and then consumes chunk k's status
        word in ONE ``host_fetch``.  The step limit is formed on the
        device, but the advance reads its loop condition before each
        dispatch (see the module docstring), so the pass waits for chunk
        k before chunk k+1's first dispatch.  Chunk k's status is a fresh
        tensor the dispatch of chunk k+1 does not write, although that
        dispatch updates the stack in place."""
        rec = trace.active()
        tr0 = rec.now() if rec is not None else 0.0
        live_uuids = ()
        t_pass = self._clock()
        now = self._clock()
        cancel_idx = self._peek_cancels(fl.jobs)
        expire_idx = [
            i for i, j in enumerate(fl.jobs)
            if not j.done.is_set() and i not in cancel_idx
            and j.deadline is not None and now > j.deadline
        ]
        if cancel_idx or expire_idx:
            # The job dimension is the padded bucket, not len(fl.jobs).
            dead = np.zeros(fl.state.solved.shape[0], bool)
            dead[cancel_idx + expire_idx] = True
            fl.state = purge_jobs(fl.state, to_device(dead, self.device))
            for i in cancel_idx:
                job = fl.jobs[i]
                if self._consume_cancel(job):
                    job.cancelled = True
                self._finish_job(job)
            for i in expire_idx:
                job = fl.jobs[i]
                job.error = "deadline expired"
                self._finish_job(job)
        if fl.config.step_impl == "fused":
            from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
                advance_frontier_fused_status as _advance,
            )
        else:
            from distributed_sudoku_solver_tpu_torch.utils.checkpoint import (
                advance_frontier_status as _advance,
            )
        if faults.active() is not None:
            faults.fire(
                "engine.advance",
                uuids=tuple(j.uuid for j in fl.jobs if not j.done.is_set()),
            )
        fl.state, status_dev = _advance(fl.state, self.chunk_steps, fl.geom, fl.config)
        fl.chunks += 1
        prev_status = fl.pending_status
        fl.pending_status = status_dev
        dispatch_s = self._clock() - t_pass
        self.dispatch_wall.record(dispatch_s)
        self.hist["dispatch_wall_ms"].record(dispatch_s)
        if rec is not None:
            live_uuids = [j.uuid for j in fl.jobs if not j.done.is_set()]
            rec.record(
                None, "chunk.dispatch", "engine.advance", tr0,
                node=self.trace_node, uuids=live_uuids, chunk=fl.chunks,
                geometry=f"{fl.geom.n}x{fl.geom.n}",
            )
        cw = compilewatch.active()
        if cw is not None and fl.chunks == 1:
            # The cost-plane seam: once per (program, shape) ever, and the
            # flight-birth guard bounds even the key to one per flight.
            # The model is host arithmetic on the shape (.shape is host
            # metadata): no device read, so no added sync.
            lanes = fl.state.has_top.shape[0]
            cw.capture_cost(
                compilewatch.ADVANCE_FUSED_STATUS
                if fl.config.step_impl == "fused"
                else compilewatch.ADVANCE_STATUS,
                (fl.geom.n, lanes, fl.config.stack_slots, fl.config.step_impl),
                lambda: advance_round_cost(fl.geom, lanes, fl.config.rules),
                geometry=f"{fl.geom.n}x{fl.geom.n}",
                lanes=lanes,
                chunk_steps=self.chunk_steps,
            )
        if prev_status is None:
            return False  # newborn flight: a full dispatch ahead from birth
        tr1 = rec.now() if rec is not None else 0.0
        t_sync = self._clock()
        info = unpack_status(
            host_fetch(prev_status, floor_s=self.handicap_s), fl.state.solved.shape[0]
        )
        sync_s = self._clock() - t_sync
        self.sync_wall.record(sync_s)
        self.hist["sync_wall_ms"].record(sync_s)
        self.rpc_floor.record(sync_s)
        if rec is not None:
            rec.record(None, "chunk.sync", "fetch.status", tr1, node=self.trace_node,
                       uuids=live_uuids, steps=int(info["steps"]))
        wall = self._clock() - t_pass
        self.chunk_wall.record(wall)
        self._chunk_wall_total += wall
        steps_delta = info["steps"] - fl.steps_seen
        fl.steps_seen = info["steps"]
        self._chunk_steps_total += steps_delta
        if fl.config.step_impl == "fused" and steps_delta > 0:
            self._occ_hist += info["hist"]
            lanes = fl.state.has_top.shape[0]
            self._occ_frac_sum += info["live_sum"] / float(lanes * steps_delta)
            self._occ_chunks += 1
        out_of_budget = info["steps"] >= fl.config.max_steps
        if info["has_work"].any() and not out_of_budget:
            # Early per-job resolution; solved rows are frozen on the
            # device, so reading them from chunk k+1's state is exact.
            solved = info["solved"]
            newly = [i for i, job in enumerate(fl.jobs) if solved[i] and not job.done.is_set()]
            if newly:
                self._resolve_solved(fl, newly)
            return False
        res = _finalize(fl.state)
        fl.state = None
        fl.pending_status = None
        tr_ev = rec.now() if rec is not None else 0.0
        t_ev = self._clock()
        solutions, unsat, nodes, solved, sol_counts = host_fetch(
            (res.solution, res.unsat, res.nodes, res.solved, res.sol_count),
            floor_s=self.handicap_s, tag="finalize",
        )
        fin_s = self._clock() - t_ev
        self.event_wall.record(fin_s)
        self.hist["event_wall_ms"].record(fin_s)
        if rec is not None:
            rec.record(None, "finalize.sync", "fetch.finalize", tr_ev,
                       node=self.trace_node, uuids=live_uuids)
        for i, job in enumerate(fl.jobs):
            if job.done.is_set():
                continue
            job.solved = bool(solved[i])
            job.exhausted = bool(unsat[i])
            job.unsat = job.exhausted and job.shed_parts == 0
            job.nodes = int(nodes[i])
            job.sol_count = int(sol_counts[i])
            if job.solved or job.sol_count > 0:
                job.solution = solutions[i]
            if self._consume_cancel(job):
                job.cancelled = True
            self._finish_job(job)
        self.batch_sizes.record(float(len(fl.jobs)))
        return True

    def _resolve_solved(self, fl: _Flight, idx: list) -> None:
        """ONE batched event fetch for every job that solved this chunk
        (decoded grids and node counts of the whole bucket)."""
        rec = trace.active()
        tr_ev = rec.now() if rec is not None else 0.0
        t_ev = self._clock()
        solutions, nodes = host_fetch(
            (decode_grid(fl.state.solution), fl.state.nodes),
            floor_s=self.handicap_s, tag="event",
        )
        ev = self._clock() - t_ev
        self.event_wall.record(ev)
        self.hist["event_wall_ms"].record(ev)
        if rec is not None:
            rec.record(None, "verdict.sync", "fetch.event", tr_ev, node=self.trace_node,
                       uuids=[fl.jobs[i].uuid for i in idx])
        # The fetch waited out chunk k+1's device wall.
        self._chunk_wall_total += ev
        for i in idx:
            job = fl.jobs[i]
            job.solved = True
            job.solution = np.asarray(solutions[i], np.int32)
            job.nodes = int(nodes[i])
            self._finish_job(job)

    def _fire_on_resolve(self, job: Job) -> None:
        """The job's resolution hook, at most once, never fatal."""
        cb = job.on_resolve
        if cb is not None:
            job.on_resolve = None
            try:
                cb(job)
            except Exception:  # noqa: BLE001
                _LOG.exception("[engine] on_resolve hook failed for %s", job.uuid)

    def _finish_job(self, job: Job) -> None:
        if job.shadow:
            # Accounting-invisible (see Job.shadow): the race that submitted
            # this job counts the user's one request itself.
            self._fire_on_resolve(job)
            job.done.set()
            return
        wall = self._clock() - job.submitted_at
        self.latency.record(wall)
        # Runs with no lock held (every caller's contract).
        with self._lock:
            if job.solved:
                self.solved_count += 1
            self.validations += job.nodes
            self.jobs_done += 1
        rec = trace.active()
        self.hist["latency_ms"].record(wall, exemplar=job.uuid if rec is not None else None)
        mon = slo.active()
        if mon is not None:
            mon.observe(wall, error=job.error is not None, stream="job")
        if rec is not None:
            rec.event(
                job.uuid, "resolve", "engine.resolve", node=self.trace_node,
                solved=job.solved, unsat=job.unsat, cancelled=job.cancelled,
                nodes=job.nodes, error=job.error,
            )
            cp = critpath.active()
            if cp is not None:
                cp.observe_job(job.uuid, wall)
        ot = ordertrace.active()
        if ot is not None:
            ot.route(job.uuid, job.probe_score, job.probe_empties, job.route or "direct",
                     wall * 1000.0, job.solved, job.unsat, job.nodes)
            if job.roots is None and job.grid is not None:
                ot.grid(job.grid, job.geom.n)
        # The front door's cache fill, before the done event.
        self._fire_on_resolve(job)
        self._journal_resolved(job)
        job.done.set()

    # -- control requests (snapshot / shed) ----------------------------------
    def _service_controls(self) -> None:
        while True:
            try:
                req = self._control.get_nowait()
            except queue.Empty:
                return
            with req.lock:
                if req.abandoned:
                    req.done.set()
                    continue
                req.claimed = True
            try:
                if req.kind == "snapshot":
                    req.result = self._do_snapshot(req.uuid)
                elif req.kind == "shed":
                    req.result = self._do_shed(req.k)
                elif req.kind == "exec":
                    req.result = req.fn()
            except Exception as e:  # noqa: BLE001
                req.result = None
                req.error = f"{type(e).__name__}: {e}"
                _LOG.error("[engine] control %s failed: %r [%s]",
                           req.kind, e, faults.classify(e))
            finally:
                req.done.set()

    def _find_flight(self, job_uuid: str):
        for fl in self._flights:
            for i, job in enumerate(fl.jobs):
                if job.uuid == job_uuid:
                    return fl, i
        return None, -1

    def _do_snapshot(self, job_uuid: str):
        fl, i = self._find_flight(job_uuid)
        if fl is None or fl.jobs[i].done.is_set():
            return None
        # One control sync for the whole frontier.
        st = host_fetch(fl.state, floor_s=self.handicap_s, tag="control")
        rows = _rows_of_job_host(st, i)
        if rows.shape[0] == 0:
            return None
        return rows, int(st.nodes[i]), fl.jobs[i].shed_parts, dataclasses.asdict(fl.config)

    def _do_shed(self, k: int):
        best = None  # (stack_rows, flight, job index)
        for fl in self._flights:
            if fl.config.count_all:
                continue  # an enumeration's shed rows would be counted nowhere
            jobv, countv, solvedv = host_fetch(
                (fl.state.job, fl.state.count, fl.state.solved),
                floor_s=self.handicap_s, tag="control",
            )
            for i, job in enumerate(fl.jobs):
                if job.done.is_set() or solvedv[i]:
                    continue
                depth = int(countv[jobv == i].sum())
                if depth >= 1 and (best is None or depth > best[0]):
                    best = (depth, fl, i)
        if best is None:
            return None
        _, fl, i = best
        fl.state, rows, valid = shed_rows(fl.state, i, k)
        rows, valid = host_fetch((rows, valid), floor_s=self.handicap_s, tag="control")
        rows = rows[valid].view(np.uint32)
        if rows.shape[0] == 0:
            return None
        fl.jobs[i].shed_parts += 1
        return fl.jobs[i].uuid, rows, dataclasses.asdict(fl.config)

    # -- legacy one-dispatch path (solve_fn overrides) ------------------------
    def _solve_group(self, geom: Geometry, group: list[Job],  # syncck: allow(legacy one-dispatch path: solve_fn overrides return device values and blocking fetches are its documented semantics)
                     cfg: Optional[SolverConfig] = None) -> None:
        cfg = cfg or self.config
        if cfg.lanes > 0 and len(group) > cfg.lanes:
            for i in range(0, len(group), cfg.lanes):
                self._solve_group(geom, group[i : i + cfg.lanes], cfg)
            return
        if self.handicap_s:
            # clockck: allow(slow-node simulator: the legacy solve_fn path charges its handicap per batch, by design)
            time.sleep(self.handicap_s)
        for job in group:
            if job.roots is not None:
                job.error = "roots jobs require the flight path (no solve_fn override)"
                job.done.set()
        group = [j for j in group if not j.done.is_set()]
        if not group:
            return
        n = geom.n
        bucket = _bucket(len(group), self.max_batch)
        if cfg.lanes > 0:
            bucket = min(bucket, cfg.lanes)
        grids = np.zeros((bucket, n, n), dtype=np.int32)
        for i, job in enumerate(group):
            grids[i] = job.grid
        # Padding rows hold a pre-solved board: they resolve on step one.
        from distributed_sudoku_solver_tpu_torch.utils.puzzles import solved_board

        grids[len(group):] = solved_board(geom)
        res = self._solve_fn(grids, geom, cfg)

        def host(v):
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

        solved = host(res.solved)
        unsat = host(res.unsat)
        solutions = host(res.solution)
        nodes = host(res.nodes)
        sol_counts = host(getattr(res, "sol_count", solved.astype(np.int32)))
        now = self._clock()
        rec = trace.active()
        mon = slo.active()
        for i, job in enumerate(group):
            job.solved = bool(solved[i])
            job.unsat = bool(unsat[i])
            job.nodes = int(nodes[i])
            job.sol_count = int(sol_counts[i])
            if job.solved or job.sol_count > 0:
                job.solution = solutions[i]
            if self._consume_cancel(job):
                job.cancelled = True
            wall = now - job.submitted_at
            self.latency.record(wall)
            self.hist["latency_ms"].record(wall, exemplar=job.uuid if rec is not None else None)
            if mon is not None:
                mon.observe(wall, error=job.error is not None, stream="job")
            if rec is not None:
                rec.event(job.uuid, "resolve", "engine.resolve", node=self.trace_node,
                          solved=job.solved, unsat=job.unsat, cancelled=job.cancelled,
                          nodes=job.nodes, error=job.error)
                cp = critpath.active()
                if cp is not None:
                    cp.observe_job(job.uuid, wall)
            self._fire_on_resolve(job)  # as in _finish_job
            self._journal_resolved(job)
            job.done.set()
        self.batch_sizes.record(float(len(group)))
        with self._lock:
            self.validations += int(nodes[: len(group)].sum())
            self.solved_count += int(solved[: len(group)].sum())
            self.jobs_done += len(group)


def _rows_of_job_host(state, job_index: int) -> np.ndarray:
    """All surviving subtree roots of one job (its lanes' tops and stack
    rows) from a host-fetched frontier, as uint32 rows: the snapshot
    payload and the offload wire format."""
    top = state.top.view(np.uint32)
    stack = state.stack.view(np.uint32)
    s = stack.shape[1]
    rows = []
    for lane in np.nonzero(state.job == job_index)[0]:
        if state.has_top[lane]:
            rows.append(top[lane])
        for i in range(int(state.count[lane])):
            rows.append(stack[lane, (int(state.base[lane]) + i) % s])
    if not rows:
        return np.zeros((0,) + top.shape[1:], np.uint32)
    return np.stack(rows).astype(np.uint32)
