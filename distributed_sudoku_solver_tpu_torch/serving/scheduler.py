"""Continuous-batching resident flights: an admission scheduler that packs
live traffic into one long-lived frontier per geometry.

Port of the JAX package's ``serving/scheduler.py``; the host logic is the
reference's, the device programs are plain functions on the port's flight
operations (``ops.frontier.init_frontier_roots``, ``attach_roots``,
``detach``; ``ops.bitmask.encode_grid``, ``decode_grid``).

* **One resident frontier per geometry**, shape-stable: ``L = job_slots *
  gang_lanes`` lanes and ``job_slots`` job rows.
* **Slot = gang of lanes.**  Slot ``j`` owns lanes ``[j*gang, (j+1)*gang)``
  and stealing is scoped to the gang (``SolverConfig.steal_gang``), so
  detaching a job frees its whole gang for the next tenant.
* **Admission between dispatches.**  Arriving jobs enter a bounded FIFO
  queue; between chunks the scheduler detaches finished slots and
  attaches queued jobs on the device.
* **One sync per chunk, one chunk behind.**  Each round consumes the
  previous advance's packed status word in one ``host_fetch``; detach,
  attach and the next advance are then dispatched without reading the
  device.  Verdicts react one chunk late (sound: a solved slot's rows
  freeze on the device, and a workless gang cannot regrow work).
* **Backpressure, deadlines, cancellation**: a full queue rejects with a
  retry hint (HTTP 429 + Retry-After); every admitted job carries a
  deadline; a cancel frees the slot at the next chunk boundary.

All device work happens on the engine's device-loop thread
(``ResidentFlight.step``); the admission queue is the only cross-thread
surface.  The advances update the frontier's stack in place (JAX donates
it): after a failed program the state is dropped and rebuilt from the
jobs' grids.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import deque
from typing import Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.obs import compilewatch, lockdep, trace
from distributed_sudoku_solver_tpu_torch.obs.logctx import uuids_label
from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
from distributed_sudoku_solver_tpu_torch.ops.cost import advance_round_cost
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    SolverConfig,
    attach_roots,
    detach,
    init_frontier_roots,
    unpack_status,
)
from distributed_sudoku_solver_tpu_torch.serving import engine as engine_mod
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.utils.profiling import StatWindow

_LOG = logging.getLogger(__name__)

# The resident frontier never retires: wall-clock deadlines replace the
# step budget, and int32 max keeps the steps-vs-max_steps guard open.
_NO_STEP_BUDGET = (1 << 31) - 1
# Rebase the step counter well before int32 overflow (limits are relative).
_REBASE_STEPS = 1 << 30


class EngineSaturated(RuntimeError):
    """Resident admission queue is full; retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"admission queue saturated; retry after {retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class ResidentConfig:
    """Static shape of a resident flight (one per geometry)."""

    job_slots: int = 16  # concurrent jobs resident on the device
    gang_lanes: int = 8  # lanes per slot
    queue_depth: int = 64  # admission queue bound; beyond it submits are rejected
    attach_batch: int = 8  # max jobs attached per chunk boundary
    chunk_steps: int = 64  # frontier rounds per resident dispatch
    default_deadline_s: float = 300.0  # wall-clock budget per job
    mesh_devices: int = 0  # > 1: the mesh-resident flight (ROADMAP A12)

    def __post_init__(self) -> None:
        if self.job_slots < 1:
            raise ValueError(f"job_slots must be >= 1, got {self.job_slots}")
        if self.gang_lanes < 1:
            raise ValueError(f"gang_lanes must be >= 1, got {self.gang_lanes}")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.attach_batch < 1:
            raise ValueError(f"attach_batch must be >= 1, got {self.attach_batch}")
        if self.mesh_devices < 0:
            raise ValueError(f"mesh_devices must be >= 0, got {self.mesh_devices}")


# -- the device programs (plain functions on the flight operations) -----------


def _init_resident(geom: Geometry, config: SolverConfig, n_slots: int,
                   device: torch.device) -> Frontier:
    lanes = config.lanes
    return init_frontier_roots(
        torch.zeros((lanes, geom.n, geom.n), dtype=torch.int32, device=device),
        torch.full((lanes,), -1, dtype=torch.int32, device=device), n_slots, config,
    )


def _attach(state: Frontier, grids: np.ndarray, slot_ids: np.ndarray, geom: Geometry,
            gang: int) -> Frontier:
    dev = state.top.device
    return attach_roots(
        state, encode_grid(engine_mod.to_device(grids, dev), geom),
        engine_mod.to_device(slot_ids, dev), gang,
    )


def _detach(state: Frontier, slot_mask: np.ndarray) -> Frontier:
    return detach(state, engine_mod.to_device(slot_mask, state.top.device))


def _verdict(state: Frontier):
    """Detach-time verdict payload (per-slot node counts, model counts,
    overflow flags, decoded solution grids), fetched only on rounds where
    a slot leaves."""
    return state.nodes, state.sol_count, state.overflowed, decode_grid(state.solution)


def resident_solver_config(base: SolverConfig, geom: Geometry, rcfg: ResidentConfig
                           ) -> SolverConfig:
    """The shape-stable SolverConfig a resident flight runs: fixed lanes,
    gang-scoped stealing, no step budget.

    For a fused base config the lane count must be kernel-valid
    (``ops.cuda_step.fused_lanes``: up to 128, or a multiple of 128) and an
    exact multiple of ``job_slots``: the gang is bumped to the smallest
    width satisfying both.  Raises ``ValueError`` when K2 cannot serve the
    geometry and stack at all (the caller falls back to static flights)."""
    gang = rcfg.gang_lanes
    lanes = gang * rcfg.job_slots
    if base.step_impl == "fused":
        from distributed_sudoku_solver_tpu_torch.ops.cuda_step import fused_lanes

        if lanes > 128:
            step = 128 // math.gcd(rcfg.job_slots, 128)
            gang = -(-gang // step) * step
            lanes = gang * rcfg.job_slots
        fused_lanes(lanes, geom.n, base.stack_slots)  # raises on misfit
    return dataclasses.replace(
        base, lanes=lanes, min_lanes=lanes, steal_gang=gang,
        max_steps=_NO_STEP_BUDGET, count_all=False,
    )


class ResidentFlight:
    """One long-lived frontier + its slot allocator and admission queue.

    ``admit`` / ``try_admit`` / ``retry_after_s`` / ``metrics`` may be
    called from any thread; ``step`` / ``on_failure`` / ``drain`` only from
    the engine's device-loop thread."""

    ADMITTED = "admitted"
    SATURATED = "saturated"  # healthy but full: the one verdict that may 429
    DEFLECTED = "deflected"  # breaker open or flight closed: static fallback

    def __init__(self, engine, geom: Geometry, rcfg: ResidentConfig):
        self.engine = engine
        self.geom = geom
        self.rcfg = rcfg
        self.config = self._solver_config(engine.config, geom, rcfg)
        self.gang = self.config.steal_gang
        self.n_slots = self.config.lanes // self.gang
        self.state: Optional[Frontier] = None  # created lazily on the loop
        # The un-fetched status word of the latest advance, and the host
        # copy of the last consumed one.
        self._pending_status = None
        self._status: Optional[dict] = None
        self._event_wall = 0.0
        self.slots: list = [None] * self.n_slots  # slot -> Job
        self._free: deque = deque(range(self.n_slots))
        self._pending: deque = deque()  # FIFO admission queue
        self._lock = lockdep.named_lock("serving.scheduler")  # lockck: name(serving.scheduler)
        self._closed = False
        self.policy = engine.recovery
        self.breaker = faults.CircuitBreaker(self.policy)
        self._cooldown_until = 0.0
        self.rebuilds = 0
        self.rebuild_requeued = 0
        self.requeued_static = 0
        self.breaker_deflected = 0  # lockck: guard(_lock)
        self.closed_deflected = 0  # lockck: guard(_lock)
        self.admitted = 0  # lockck: guard(_lock)
        self.rejected = 0  # lockck: guard(_lock)
        self.completed = 0
        self.cancelled = 0
        self.expired = 0
        self.chunks = 0
        self.admission_wait = StatWindow()  # submit -> attach seconds
        self.chunk_wall = StatWindow()  # per-chunk status-sync wall
        self.dispatch_wall = StatWindow()  # host time enqueueing a round's work
        self.event_wall = StatWindow()  # detach-round verdict fetches
        # Frontier-round and status-sync wall totals (the device loop is
        # the one writer), summed by the engine's device-efficiency gauge
        # (obs/compilewatch.py) so a resident-serving node lights it.
        self.rounds_total = 0
        self.round_wall_total = 0.0
        self._steps_seen = 0

    # -- strategy hooks (the mesh flight swaps the device programs) ---------
    def _solver_config(self, base: SolverConfig, geom: Geometry, rcfg: ResidentConfig
                       ) -> SolverConfig:
        return resident_solver_config(base, geom, rcfg)

    def _unpack(self, raw) -> dict:
        return unpack_status(raw, self.n_slots)

    def _init_state(self):
        return _init_resident(self.geom, self.config, self.n_slots, self.engine.device)

    def _attach_state(self, grids: np.ndarray, slot_ids: np.ndarray):
        return _attach(self.state, grids, slot_ids, self.geom, self.gang)

    def _detach_state(self, slot_mask: np.ndarray):
        return _detach(self.state, slot_mask)

    def _verdict_state(self) -> Frontier:
        """The frontier whose per-job rows hold the verdicts."""
        return self.state

    def _rebase_state(self):
        return self.state._replace(
            steps=torch.zeros_like(self.state.steps),
            lane_rounds=torch.zeros_like(self.state.lane_rounds),
        )

    def _advance_program(self) -> str:
        """The registry name the cost plane prices this flight's advance
        under (``analysis/manifest.py``)."""
        if self.config.step_impl == "fused":
            return compilewatch.ADVANCE_FUSED_STATUS
        return compilewatch.ADVANCE_STATUS

    def _advance_state(self):
        """Dispatch one bounded-step chunk: ``(new state, status word)``."""
        if self.config.step_impl == "fused":
            from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
                advance_frontier_fused_status as advance,
            )
        else:
            from distributed_sudoku_solver_tpu_torch.utils.checkpoint import (
                advance_frontier_status as advance,
            )
        return advance(self.state, self.rcfg.chunk_steps, self.geom, self.config)

    # -- any-thread surface --------------------------------------------------
    def admit(self, job) -> str:
        """Queue ``job`` for attachment; returns an admission verdict."""
        if not self.breaker.allow():
            with self._lock:
                self.breaker_deflected += 1
            return self.DEFLECTED
        with self._lock:
            if self._closed:
                self.closed_deflected += 1
                return self.DEFLECTED
            if len(self._pending) >= self.rcfg.queue_depth:
                self.rejected += 1
                return self.SATURATED
            if job.deadline is None:
                job.deadline = self.engine._clock() + self.rcfg.default_deadline_s
            self._pending.append(job)
            self.admitted += 1
            return self.ADMITTED

    def try_admit(self, job) -> bool:
        return self.admit(job) == self.ADMITTED

    def retry_after_s(self) -> float:
        """Backpressure hint: the backlog ahead of a retry, paced at the
        recent per-job latency over ``job_slots`` parallel servers."""
        lat = self.engine.latency.snapshot()
        per_job = lat["p50"] if lat else 0.5
        with self._lock:
            backlog = len(self._pending) + sum(1 for s in self.slots if s is not None)
        return float(min(30.0, max(0.1, per_job * backlog / self.n_slots)))

    def cooling(self) -> bool:
        return self.policy.clock() < self._cooldown_until

    def active(self) -> bool:
        if self.cooling():
            return False
        with self._lock:
            return bool(self._pending) or any(s is not None for s in self.slots)

    def queued_depth(self) -> int:
        with self._lock:
            return len(self._pending) + sum(1 for s in self.slots if s is not None)

    def admission_pressure(self) -> tuple:
        """``(queue_fraction, admission_wait_p95_s)`` for the brownout controller."""
        with self._lock:
            frac = len(self._pending) / float(self.rcfg.queue_depth)
        aw = self.admission_wait.snapshot()
        return frac, (aw["p95"] if aw else 0.0)

    def metrics(self) -> dict:
        with self._lock:
            occupied = sum(1 for s in self.slots if s is not None)
            queued = len(self._pending)
        out = {
            "slots": self.n_slots,
            "gang_lanes": self.gang,
            "occupied": occupied,
            "queued": queued,
            "admitted": int(self.admitted),
            "completed": int(self.completed),
            "rejected": int(self.rejected),
            "cancelled": int(self.cancelled),
            "deadline_expired": int(self.expired),
            "chunks": int(self.chunks),
        }
        aw = self.admission_wait.snapshot()
        if aw:
            out["admission_wait_ms"] = {
                "count": aw["count"],
                **{k: round(aw[k] * 1e3, 3) for k in ("p50", "p95", "p99")},
            }
        for name, win in (
            ("chunk_wall_ms", self.chunk_wall),
            ("dispatch_wall_ms", self.dispatch_wall),
            ("event_wall_ms", self.event_wall),
        ):
            snap = win.snapshot()
            if snap:
                out[name] = {
                    "count": snap["count"],
                    **{k: round(snap[k] * 1e3, 3) for k in ("p50", "p95")},
                }
        out["faults"] = {
            "rebuilds": int(self.rebuilds),
            "rebuild_requeued": int(self.rebuild_requeued),
            "requeued_static": int(self.requeued_static),
            "breaker_deflected": int(self.breaker_deflected),
            "closed_deflected": int(self.closed_deflected),
            "breaker": self.breaker.metrics(),
        }
        return out

    # -- device-loop surface -------------------------------------------------
    def step(self) -> None:
        """One scheduler round: sweep -> consume status -> collect ->
        detach -> attach -> advance.  The round's one host sync is the
        status consumption; the rest is dispatched without waiting."""
        self._sweep_pending()
        if self.cooling():
            return
        self._consume_status()
        t0 = self.engine._clock()
        self._event_wall = 0.0
        self._collect_and_detach()
        self._attach_pending()
        self._advance()
        if self._pending_status is not None:
            self.dispatch_wall.record(self.engine._clock() - t0 - self._event_wall)

    def _consume_status(self) -> None:
        """Fetch the previous advance's status word (the round's single
        host sync); no-op when no advance is outstanding."""
        if self._pending_status is None:
            return
        rec = trace.active()
        tr0 = rec.now() if rec is not None else 0.0
        t0 = self.engine._clock()
        raw = engine_mod.host_fetch(self._pending_status, floor_s=self.engine.handicap_s)
        self._pending_status = None
        self._status = self._unpack(raw)
        sync_s = self.engine._clock() - t0
        self.chunk_wall.record(sync_s)
        self.engine.hist["chunk_wall_ms"].record(sync_s)
        self.engine.rpc_floor.record(sync_s)
        self.chunks += 1
        # Round and wall totals for the device-efficiency gauge.  A
        # negative delta is the rebase's reset: take the new baseline and
        # skip the sample.
        steps = self._status["steps"]
        delta = steps - self._steps_seen
        self._steps_seen = steps
        if delta > 0:
            self.rounds_total += delta
            self.round_wall_total += sync_s
        # A consumed chunk is the breaker's success.
        if rec is None:
            self.breaker.record_success()
        else:
            rec.record(
                None, "resident.sync", "fetch.status", tr0, node=self.engine.trace_node,
                chunk=self.chunks, geometry=f"{self.geom.n}x{self.geom.n}",
                uuids=[j.uuid for j in self.slots if j is not None],
            )
            before = self.breaker.state
            self.breaker.record_success()
            if self.breaker.state != before:
                rec.event(None, "breaker", "resident.breaker", node=self.engine.trace_node,
                          geometry=f"{self.geom.n}x{self.geom.n}",
                          attrs={"from": before, "to": self.breaker.state})

    def _resolve_dead(self, job, cancelled: bool) -> None:
        """Resolve a job leaving with no verdict (cancel or deadline)."""
        if cancelled:
            job.cancelled = True
            self.cancelled += 1
        else:
            job.error = "deadline expired"
            self.expired += 1
        self.engine._finish_job(job)

    def _sweep_pending(self) -> None:
        """Resolve cancelled/expired jobs still waiting in the queue, so dead
        entries never hold the bounded queue full."""
        now = self.engine._clock()
        with self._lock:
            queued = list(self._pending)
        dead = []
        for job in queued:
            cancelled = self.engine._consume_cancel(job)
            expired = job.deadline is not None and now > job.deadline
            if cancelled or expired:
                dead.append((job, cancelled))
        if not dead:
            return
        with self._lock:
            for job, _ in dead:
                self._pending.remove(job)
        for job, cancelled in dead:
            self._resolve_dead(job, cancelled)

    def _collect_and_detach(self) -> None:
        """Resolve finished/cancelled/expired slot jobs and recycle their
        slots, from the last consumed status word; the verdict payload is
        fetched only on rounds where a slot leaves with a verdict."""
        if self.state is None or self._status is None or all(s is None for s in self.slots):
            return
        solved = self._status["solved"]
        has_work = self._status["has_work"]
        now = self.engine._clock()
        detach_mask = np.zeros(self.n_slots, bool)
        leaving: list = []  # (slot, job, cancelled, expired)
        for slot, job in enumerate(self.slots):
            if job is None:
                continue
            cancelled = self.engine._consume_cancel(job)
            expired = job.deadline is not None and now > job.deadline
            if not (solved[slot] or not has_work[slot] or cancelled or expired):
                continue
            detach_mask[slot] = True
            leaving.append((slot, job, cancelled, expired))
        if not leaving:
            return
        nodes = sol_counts = overflowed = solutions = None
        if any(solved[slot] or (not has_work[slot] and not cancelled)
               for slot, job, cancelled, expired in leaving):
            rec = trace.active()
            tr_ev = rec.now() if rec is not None else 0.0
            t_ev = self.engine._clock()
            nodes, sol_counts, overflowed, solutions = engine_mod.host_fetch(
                _verdict(self._verdict_state()), floor_s=self.engine.handicap_s, tag="event"
            )
            self._event_wall = self.engine._clock() - t_ev
            self.event_wall.record(self._event_wall)
            self.engine.hist["event_wall_ms"].record(self._event_wall)
            if rec is not None:
                rec.record(None, "verdict.sync", "fetch.event", tr_ev,
                           node=self.engine.trace_node,
                           uuids=[j.uuid for _, j, _, _ in leaving])
        for slot, job, cancelled, expired in leaving:
            if solved[slot]:
                job.solved = True
                job.solution = np.asarray(solutions[slot], np.int32)
                job.sol_count = int(sol_counts[slot])
            elif not has_work[slot] and not cancelled:
                # Exhausted: a proof unless an overflow dropped a subtree.
                job.exhausted = not overflowed[slot]
                job.unsat = job.exhausted
            if nodes is not None:
                job.nodes = int(nodes[slot])
            self.slots[slot] = None
            with self._lock:
                self._free.append(slot)
            self.completed += 1
            if cancelled or (expired and not (job.solved or job.unsat or job.exhausted)):
                self._resolve_dead(job, cancelled)
            else:
                self.engine._finish_job(job)
        if faults.active() is not None:
            faults.fire("resident.detach",
                        uuids=tuple(j.uuid for j in self.slots if j is not None))
        self.state = self._detach_state(detach_mask)

    def _attach_pending(self) -> None:
        """FIFO-drain the admission queue into free slots, one attach batch
        per chunk boundary."""
        now = self.engine._clock()
        batch: list = []
        while len(batch) < self.rcfg.attach_batch:
            with self._lock:
                if not self._pending or not self._free:
                    break
                job = self._pending.popleft()
                slot = self._free.popleft()
            cancelled = self.engine._consume_cancel(job)
            expired = job.deadline is not None and now > job.deadline
            if cancelled or expired:
                with self._lock:
                    self._free.appendleft(slot)
                self._resolve_dead(job, cancelled)
                continue
            # Recorded before any device call, so a failing program's
            # recovery finds the job in self.slots.
            self.slots[slot] = job
            batch.append((slot, job))
        if not batch:
            return
        rec = trace.active()
        if rec is not None:
            t1 = rec.now()
            for slot, job in batch:
                rec.record(job.uuid, "admission", "resident.attach",
                           t0=job.trace_t0 if job.trace_t0 is not None else t1, t1=t1,
                           node=self.engine.trace_node, route="resident", slot=slot)
        if faults.active() is not None:
            faults.fire("resident.attach", uuids=tuple(job.uuid for _, job in batch))
        if self.state is None:
            self.state = self._init_state()
        n = self.geom.n
        k = self.rcfg.attach_batch
        grids = np.zeros((k, n, n), np.int32)
        slot_ids = np.full(k, -1, np.int32)
        for i, (slot, job) in enumerate(batch):
            grids[i] = job.grid
            slot_ids[i] = slot
            wait_s = now - job.submitted_at
            self.admission_wait.record(wait_s)
            self.engine.hist["admission_wait_ms"].record(wait_s)
        self.state = self._attach_state(grids, slot_ids)

    def _advance(self) -> None:
        """Dispatch one bounded-step chunk; its status is consumed at the
        next round.  The step limit is formed on the device."""
        if self.state is None or all(s is None for s in self.slots):
            return
        if self._status is not None and self._status["steps"] > _REBASE_STEPS:
            # Rebase the two monotone counters; limits are relative.
            self.state = self._rebase_state()
        if faults.active() is not None:
            faults.fire("resident.advance",
                        uuids=tuple(j.uuid for j in self.slots if j is not None))
        rec = trace.active()
        tr0 = rec.now() if rec is not None else 0.0
        self.state, self._pending_status = self._advance_state()
        if rec is not None:
            rec.record(None, "resident.chunk.dispatch", "resident.advance", tr0,
                       node=self.engine.trace_node,
                       uuids=[j.uuid for j in self.slots if j is not None])
        cw = compilewatch.active()
        if cw is not None and self.chunks == 0:
            # The cost-plane seam, the engine's twin: once per (program,
            # resident shape), from the shape alone (no device read).
            lanes = self.config.lanes
            cw.capture_cost(
                self._advance_program(),
                (self.geom.n, lanes, self.config.stack_slots, self.config.step_impl,
                 "resident"),
                lambda: advance_round_cost(self.geom, lanes, self.config.rules),
                geometry=f"{self.geom.n}x{self.geom.n}",
                lanes=lanes,
                chunk_steps=self.rcfg.chunk_steps,
                resident=True,
            )

    def on_failure(self, exc: BaseException) -> None:
        """A device program died mid-round: drop the state, charge every
        held job one retry; a transient fault requeues them here and
        schedules a rebuild after the cooldown, a permanent fault (or an
        open breaker) reroutes them to static flights (permanent also
        closes admission)."""
        kind = faults.classify(exc)
        label = f"{type(exc).__name__}: {exc}"
        rec = trace.active()
        breaker_before = self.breaker.state
        self.breaker.record_failure()
        self.state = None
        self._pending_status = None
        self._status = None
        held = [j for j in self.slots if j is not None]
        self.slots = [None] * self.n_slots
        with self._lock:
            held.extend(self._pending)
            self._pending.clear()
            self._free = deque(range(self.n_slots))
        survivors = [
            job for job in held
            if not job.done.is_set() and self.engine._charge_retry(job, kind, label)
        ]
        if rec is not None and self.breaker.state != breaker_before:
            rec.event(None, "breaker", "resident.breaker", node=self.engine.trace_node,
                      geometry=f"{self.geom.n}x{self.geom.n}",
                      attrs={"from": breaker_before, "to": self.breaker.state})
            if self.breaker.state == self.breaker.OPEN:
                rec.dump("breaker_open", metrics=self.engine.metrics())
        if kind == faults.PERMANENT or self.breaker.state == self.breaker.OPEN:
            for job in survivors:
                self.engine._requeue(job)
            self.requeued_static += len(survivors)
            if kind == faults.PERMANENT:
                with self._lock:
                    self._closed = True
            _LOG.warning(
                "[resident %sx%s] %s failure: rerouted %d jobs to static flights (%s): %s",
                self.geom.n, self.geom.n, kind, len(survivors), uuids_label(survivors), label,
            )
            if rec is not None:
                rec.event(None, "recovery.reroute", "resident.recovery",
                          node=self.engine.trace_node, kind=kind,
                          uuids=[j.uuid for j in survivors], error=label)
        else:
            with self._lock:
                self._pending.extendleft(reversed(survivors))
            self.rebuild_requeued += len(survivors)
            self.rebuilds += 1
            self._cooldown_until = self.policy.clock() + self.policy.rebuild_cooldown_s
            _LOG.warning(
                "[resident %sx%s] transient failure: rebuild scheduled, %d jobs "
                "requeued (%s): %s",
                self.geom.n, self.geom.n, len(survivors), uuids_label(survivors), label,
            )
            if rec is not None:
                rec.event(None, "recovery.rebuild", "resident.recovery",
                          node=self.engine.trace_node, kind=kind,
                          uuids=[j.uuid for j in survivors], error=label)

    def detach_pending(self) -> list:
        """Graceful drain: hand back every queued job that never attached."""
        with self._lock:
            out = [j for j in self._pending if not j.done.is_set()]
            self._pending.clear()
        return out

    def fail(self, exc: BaseException) -> None:
        """Terminal failure: fail every held job and close admission."""
        self.drain(f"{type(exc).__name__}: {exc}")

    def drain(self, reason: str = "engine stopped") -> None:
        """Resolve everything still held at shutdown."""
        with self._lock:
            self._closed = True
            stranded = list(self._pending)
            self._pending.clear()
        stranded.extend(j for j in self.slots if j is not None)
        self.slots = [None] * self.n_slots
        self._pending_status = None
        for job in stranded:
            if not job.done.is_set():
                job.error = reason
                job.done.set()
