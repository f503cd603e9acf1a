"""Latency-mode serving megastep: one flight, one ``host_fetch``, per job.

Port of the JAX package's ``serving/megastep.py``.  A
:class:`MegastepFlight` holds a small device-resident mailbox, a one-slot
resident frontier built by the resident scheduler's seams, and serves a
job as one flight:

    attach -> ``ops.frontier.advance_megastep`` (or the fused twin
    ``ops.cuda_step.advance_megastep_fused``: chunks of K2 dispatches with
    the flight-start status baselines and early exit when the board
    solves or its space drains) -> verdict payload -> ONE ``host_fetch``
    of status and verdict together -> detach.

The fetch-count contract (one ``host_fetch`` per flight, tag ``status``)
is the JAX package's.  The chunk loop is not yet on the device: the port's
megastep reads its loop condition on the host once per dispatch and once
per chunk (``ops.frontier.megastep_chunks``), where JAX runs the whole
flight as one dispatch; moving that loop onto the device is ROADMAP A8.

Degrade-to-chunked: a flight that exhausts ``max_chunks`` with work left,
overflows a lane stack, or dies in a device program does not error the
job: ``solve`` returns False and the engine routes it to the chunked
resident/static paths, which re-solve from the clue grid.  Failures feed
the flight's circuit breaker.

Accounting: the flight's wall is recorded in ``frontdoor_megastep_ms``
only, never in the per-chunk ``chunk_wall_ms`` / ``sync_wall_ms`` seams
or the ``rpc_floor`` estimator.

Threads: ``solve`` runs on the caller's thread (an HTTP handler),
concurrently with the engine's device loop, serialised per flight by the
rank-36 ``serving.megastep`` lock, which is released before
``engine._finish_job``.  Both threads launch on the same device; the
first use of a kernel library is serialised by ``ops.cuda_build``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.obs import compilewatch, lockdep, trace
from distributed_sudoku_solver_tpu_torch.ops.cost import advance_round_cost
from distributed_sudoku_solver_tpu_torch.ops.frontier import unpack_status
from distributed_sudoku_solver_tpu_torch.serving import engine as engine_mod
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.scheduler import (
    _REBASE_STEPS,
    ResidentConfig,
    _attach,
    _detach,
    _init_resident,
    _verdict,
    resident_solver_config,
)
from distributed_sudoku_solver_tpu_torch.utils.profiling import StatWindow

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MegastepConfig:
    """Static shape of a latency-mode flight (one per geometry).

    ``chunk_steps * max_chunks`` is the flight's step budget: a board
    still holding work past it degrades to the chunked resident path.
    Neither knob changes the verdict (the search order is chunk-invariant)."""

    gang_lanes: int = 8  # lanes speculating on the one board
    chunk_steps: int = 64  # frontier rounds per chunk
    max_chunks: int = 64  # the flight's chunk budget

    def __post_init__(self) -> None:
        if self.gang_lanes < 1:
            raise ValueError(f"gang_lanes must be >= 1, got {self.gang_lanes}")
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {self.chunk_steps}")
        if self.max_chunks < 1:
            raise ValueError(f"max_chunks must be >= 1, got {self.max_chunks}")


class MegastepFlight:
    """One geometry's latency-mode mailbox: a single-slot resident frontier
    served synchronously, one flight per job.

    Raises ``ValueError`` from the constructor when K2 cannot serve the
    geometry at the gang width (the engine counts it unfit)."""

    def __init__(self, engine, geom: Geometry, cfg: MegastepConfig):
        self.engine = engine
        self.geom = geom
        self.cfg = cfg
        self.config = resident_solver_config(
            engine.config, geom,
            ResidentConfig(job_slots=1, gang_lanes=cfg.gang_lanes, chunk_steps=cfg.chunk_steps),
        )
        self.gang = self.config.steal_gang
        if self.config.step_impl == "fused":
            from distributed_sudoku_solver_tpu_torch.ops.cuda_step import advance_megastep_fused

            self._advance_fn = advance_megastep_fused
            self._advance_prog = compilewatch.ADVANCE_MEGASTEP_FUSED
        else:
            from distributed_sudoku_solver_tpu_torch.ops.frontier import advance_megastep

            self._advance_fn = advance_megastep
            self._advance_prog = compilewatch.ADVANCE_MEGASTEP
        self.mailbox = None  # lockck: guard(_lock) — the device-resident frontier (lazy)
        self._steps_seen = 0  # lockck: guard(_lock)
        self._lock = lockdep.named_lock("serving.megastep")  # lockck: name(serving.megastep)
        self.breaker = faults.CircuitBreaker(engine.recovery)
        self.flights = 0  # lockck: guard(_lock)
        self.flights_solved = 0  # lockck: guard(_lock)
        self.flights_unsat = 0  # lockck: guard(_lock)
        self.degraded_budget = 0  # lockck: guard(_lock)
        self.degraded_overflow = 0  # lockck: guard(_lock)
        self.degraded_fault = 0  # lockck: guard(_lock)
        self.breaker_deflected = 0  # lockck: guard(_lock)
        self.chunks_total = 0  # lockck: guard(_lock)
        # Round and wall totals for the device-efficiency gauge (the
        # engine sums them with the resident ones).
        self.rounds_total = 0  # lockck: guard(_lock)
        self.round_wall_total = 0.0  # lockck: guard(_lock)
        self.flight_wall = StatWindow()  # whole-flight seconds

    def solve(self, job) -> bool:
        """Serve ``job`` as one megastep flight on the calling thread.

        True: the job is resolved (solved or proven unsat) and
        ``engine._finish_job`` has run.  False: degrade; the job was not
        touched and the caller routes it to the chunked paths."""
        if not self.breaker.allow():
            with self._lock:
                self.breaker_deflected += 1
            return False
        # The obs singletons are read before the flight lock: the lookups
        # take no lock, and keeping them out of the locked region keeps
        # the static lock graph exact.
        rec = trace.active()
        cw = compilewatch.active()
        inj = faults.active()
        with self._lock:
            try:
                verdict = self._fly_locked(job, rec, cw, inj)
            except Exception as exc:  # noqa: BLE001 - degrade, never error the job
                kind = faults.classify(exc)
                self.degraded_fault += 1
                self.breaker.record_failure()
                # The failed flight's mailbox may be half-written: rebuild.
                self.mailbox = None
                self._steps_seen = 0
                _LOG.warning(
                    "[megastep] flight failed for %s (%s: %r) — degrading to the "
                    "chunked path", job.uuid, kind, exc,
                )
                return False
            self.breaker.record_success()
            self.flights += 1
            info, chunks, nodes, sol_counts, overflowed, solutions, wall = verdict
            self.chunks_total += chunks
            delta = int(info["steps"]) - self._steps_seen
            self._steps_seen = int(info["steps"])
            if delta > 0:
                self.rounds_total += delta
                self.round_wall_total += wall
            if bool(info["solved"][0]):
                self.flights_solved += 1
            elif not bool(info["has_work"][0]) and not bool(overflowed[0]):
                self.flights_unsat += 1
            elif bool(info["has_work"][0]):
                self.degraded_budget += 1
                return False
            else:
                self.degraded_overflow += 1
                return False
        # Outside the flight lock: _finish_job enters the rank-24 SLO lock.
        self.flight_wall.record(wall)
        self.engine.hist["frontdoor_megastep_ms"].record(wall)
        if bool(info["solved"][0]):
            job.solved = True
            job.solution = np.asarray(solutions[0], np.int32)
            job.sol_count = int(sol_counts[0])
        else:
            job.exhausted = True  # exhausted, no overflow: a complete proof
            job.unsat = True
        job.nodes = int(nodes[0])
        self.engine._finish_job(job)
        return True

    def _fly_locked(self, job, rec, cw, inj) -> tuple:
        """One flight under the lock: attach -> megastep -> verdict -> the
        ONE host fetch -> detach.  Returns the host-side payload."""
        t0 = self.engine._clock()
        geom, config = self.geom, self.config
        if self.mailbox is not None and self._steps_seen > _REBASE_STEPS:
            self.mailbox = self.mailbox._replace(
                steps=torch.zeros_like(self.mailbox.steps),
                lane_rounds=torch.zeros_like(self.mailbox.lane_rounds),
            )
            self._steps_seen = 0
        if self.mailbox is None:
            self.mailbox = _init_resident(geom, config, 1, self.engine.device)
            self._steps_seen = 0
        if rec is not None:
            t_att = rec.now()
            rec.record(job.uuid, "admission", "megastep.attach",
                       t0=job.trace_t0 if job.trace_t0 is not None else t_att, t1=t_att,
                       node=self.engine.trace_node, route="megastep")
        if inj is not None:
            faults.fire("megastep.advance", uuids=(job.uuid,))
        tr0 = rec.now() if rec is not None else 0.0
        self.mailbox = _attach(self.mailbox, job.grid[None], np.zeros(1, np.int32),
                               geom, self.gang)
        self.mailbox, status_dev, chunks = self._advance_fn(
            self.mailbox, self.cfg.chunk_steps, self.cfg.max_chunks, geom, config
        )
        if cw is not None and self.flights == 0:
            # The cost-plane seam: once per (program, shape), from the
            # shape alone (no device read).
            lanes = config.lanes
            cw.capture_cost(
                self._advance_prog,
                (geom.n, lanes, config.stack_slots, config.step_impl, "megastep"),
                lambda: advance_round_cost(geom, lanes, config.rules),
                geometry=f"{geom.n}x{geom.n}", lanes=lanes,
                chunk_steps=self.cfg.chunk_steps, max_chunks=self.cfg.max_chunks,
            )
        tr1 = rec.now() if rec is not None else 0.0
        raw_status, nodes, sol_counts, overflowed, solutions = engine_mod.host_fetch(
            (status_dev, *_verdict(self.mailbox)), floor_s=self.engine.handicap_s,
            tag="status",
        )
        wall = self.engine._clock() - t0
        if rec is not None:
            rec.record(None, "megastep.sync", "megastep.fetch.status", tr1,
                       node=self.engine.trace_node, uuids=[job.uuid], chunks=int(chunks))
            rec.record(None, "megastep.chunk.dispatch", "megastep.advance", tr0,
                       node=self.engine.trace_node, uuids=[job.uuid], chunks=int(chunks),
                       geometry=f"{geom.n}x{geom.n}")
        info = unpack_status(raw_status, 1)
        self.mailbox = _detach(self.mailbox, np.ones(1, bool))
        return info, int(chunks), nodes, sol_counts, overflowed, solutions, wall

    def metrics(self) -> dict:
        with self._lock:
            out = {
                "gang_lanes": int(self.gang),
                "chunk_steps": int(self.cfg.chunk_steps),
                "max_chunks": int(self.cfg.max_chunks),
                "flights": int(self.flights),
                "solved": int(self.flights_solved),
                "unsat": int(self.flights_unsat),
                "degraded": {
                    "budget": int(self.degraded_budget),
                    "overflow": int(self.degraded_overflow),
                    "fault": int(self.degraded_fault),
                    "breaker": int(self.breaker_deflected),
                },
                "chunks_total": int(self.chunks_total),
            }
            if self.flights > 0:
                out["chunks_per_flight"] = round(self.chunks_total / self.flights, 2)
        fw = self.flight_wall.snapshot()
        if fw:
            out["flight_wall_ms"] = {
                "count": fw["count"],
                **{k: round(fw[k] * 1e3, 3) for k in ("p50", "p95")},
            }
        out["breaker"] = self.breaker.metrics()
        return out
