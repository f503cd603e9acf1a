"""The port's latency-mode megastep (``serving/megastep.py``) against the JAX package's.

Twins of ``tests/test_megastep.py``:

* bit-identity: the megastep's verdict (solved / unsat, the solution,
  ``sol_count``) equals the chunked resident path's, for both step
  implementations, and the verdicts equal JAX's ``solve_batch``;
* degrade-to-chunked: budget exhaustion, device faults and breaker
  deflection return the job to the chunked paths unharmed, counted by
  cause;
* routing: per-request ``latency=`` overrides the engine default both
  ways; an unfit gang shape is counted once and bypassed;
* accounting: the flight's wall lands in ``frontdoor_megastep_ms`` only.

The one-``host_fetch``-per-flight guard is in
``tests/test_torch_status_pipeline.py``.  Tolerance: exact equality.
"""

import numpy as np
import pytest

from distributed_sudoku_solver_tpu.models.geometry import geometry_for_size as jgeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.megastep import MegastepConfig
from distributed_sudoku_solver_tpu_torch.serving.scheduler import ResidentConfig
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
FUSED_SMALL = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2)
MS = MegastepConfig(gang_lanes=8, chunk_steps=16, max_chunks=64)


def cpu_engine(**kw) -> SolverEngine:
    return SolverEngine(device="cpu", **kw)


def bad_board():
    bad = np.zeros((9, 9), np.int32)
    bad[0, 0] = bad[0, 1] = 5
    return bad


@pytest.fixture(autouse=True)
def port_lock_witness():
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w
    assert w.violations == [], w.violations


def _solve_chunked(cfg, boards):
    rc = ResidentConfig(job_slots=4, gang_lanes=4, queue_depth=32, attach_batch=4,
                        chunk_steps=16)
    eng = cpu_engine(config=cfg, max_batch=8, resident=rc).start()
    try:
        jobs = [eng.submit(np.asarray(b, np.int32)) for b in boards]
        for j in jobs:
            assert j.wait(240), j.error
    finally:
        eng.stop(timeout=2)
    return jobs


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_verdict_bit_identical_to_chunked(cfg):
    boards = [np.asarray(b) for b in HARD_9] + [np.asarray(EASY_9)]
    base = _solve_chunked(cfg, boards)
    want = jax_solve_batch(np.stack(boards).astype(np.int32), jgeometry(9),
                           JSolverConfig(min_lanes=8, stack_slots=16))
    eng = cpu_engine(config=cfg, max_batch=8, latency_mode=True, megastep=MS).start()
    try:
        for i, (b, ref) in enumerate(zip(boards, base)):
            j = eng.submit(np.asarray(b, np.int32))
            assert j.wait(240), j.error
            assert j.solved == ref.solved and j.unsat == ref.unsat
            np.testing.assert_array_equal(np.asarray(j.solution), np.asarray(ref.solution))
            assert j.sol_count == ref.sol_count == 1
            assert j.solved == bool(np.asarray(want.solved)[i])
            np.testing.assert_array_equal(j.solution, np.asarray(want.solution)[i])  # unique
        m = eng._megasteps[SUDOKU_9].metrics()
        assert m["flights"] == len(boards) and m["solved"] == len(boards)
        assert all(v == 0 for v in m["degraded"].values())
    finally:
        eng.stop(timeout=2)


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_unsat_board_proven_on_the_megastep(cfg):
    eng = cpu_engine(config=cfg, max_batch=8, latency_mode=True, megastep=MS).start()
    try:
        j = eng.submit(bad_board())
        assert j.wait(120)
        assert j.unsat and j.exhausted and not j.solved
        m = eng._megasteps[SUDOKU_9].metrics()
        assert m["unsat"] == 1 and m["flights"] == 1
        assert all(v == 0 for v in m["degraded"].values())
    finally:
        eng.stop(timeout=2)


def test_budget_exhaustion_degrades_to_chunked():
    tiny = MegastepConfig(gang_lanes=8, chunk_steps=1, max_chunks=1)
    eng = cpu_engine(config=SMALL, max_batch=8, latency_mode=True, megastep=tiny).start()
    try:
        j = eng.submit(HARD_9[1])
        assert j.wait(120) and j.solved, j.error
        m = eng._megasteps[SUDOKU_9].metrics()
        assert m["degraded"]["budget"] == 1
        assert m["flights"] == 1 and m["solved"] == 0
    finally:
        eng.stop(timeout=2)


def test_fault_degrades_and_breaker_deflects():
    inj = faults.FaultInjector(
        faults.FaultSchedule.at({"megastep.advance": {0: "preempt", 1: "preempt"}})
    )
    eng = cpu_engine(config=SMALL, max_batch=8, latency_mode=True, megastep=MS,
                     recovery=faults.RecoveryPolicy(breaker_failures=2,
                                                    breaker_cooldown_s=600.0)).start()
    try:
        with faults.injected(inj):
            jobs = [eng.submit(HARD_9[i % 3]) for i in range(3)]
            for j in jobs:
                assert j.wait(120) and j.solved, j.error
        m = eng._megasteps[SUDOKU_9].metrics()
        assert m["degraded"]["fault"] == 2
        assert m["degraded"]["breaker"] == 1
        assert m["flights"] == 0
        assert m["breaker"]["state"] == "open"
        assert inj.metrics()["dispatches"].get("megastep.advance") == 2
    finally:
        eng.stop(timeout=2)


def test_per_request_latency_overrides_engine_default():
    eng = cpu_engine(config=SMALL, max_batch=8, megastep=MS).start()
    try:
        j1 = eng.submit(HARD_9[0], latency=True)
        assert j1.wait(120) and j1.solved, j1.error
        assert eng._megasteps[SUDOKU_9].flights == 1
        j2 = eng.submit(HARD_9[1])
        assert j2.wait(120) and j2.solved, j2.error
        assert eng._megasteps[SUDOKU_9].flights == 1
    finally:
        eng.stop(timeout=2)
    eng = cpu_engine(config=SMALL, max_batch=8, latency_mode=True, megastep=MS).start()
    try:
        j = eng.submit(HARD_9[0], latency=False)
        assert j.wait(120) and j.solved, j.error
        assert SUDOKU_9 not in eng._megasteps
    finally:
        eng.stop(timeout=2)


def test_unfit_gang_shape_counted_once_and_bypassed(monkeypatch):
    import distributed_sudoku_solver_tpu_torch.serving.megastep as megastep_mod

    def misfit(base, geom, rcfg):
        raise ValueError("forced gang-shape misfit")

    monkeypatch.setattr(megastep_mod, "resident_solver_config", misfit)
    eng = cpu_engine(config=SMALL, max_batch=8, latency_mode=True, megastep=MS).start()
    try:
        jobs = [eng.submit(HARD_9[0]), eng.submit(HARD_9[1])]
        for j in jobs:
            assert j.wait(120) and j.solved, j.error
        m = eng.metrics()
        assert m["megastep_unfit"] == 1
        assert "megastep" not in m
    finally:
        eng.stop(timeout=2)


def test_single_sync_never_double_counted():
    eng = cpu_engine(config=SMALL, max_batch=8, latency_mode=True, megastep=MS).start()
    try:
        for b in (HARD_9[0], EASY_9):
            j = eng.submit(np.asarray(b, np.int32))
            assert j.wait(120) and j.solved, j.error
        m = eng.metrics()
        ms = m["megastep"]["9x9"]
        assert ms["flights"] == 2 and ms["solved"] == 2
        assert ms["chunks_per_flight"] >= 1
        assert ms["flight_wall_ms"]["count"] == 2
        assert sum(m["hist"]["frontdoor_megastep_ms"]["counts"]) == 2
        assert not eng.chunk_wall.snapshot()
        assert not eng.sync_wall.snapshot()
        assert "chunk_wall_ms" not in m["hist"]
        assert "sync_wall_ms" not in m["hist"]
        assert "rpc_floor_ms" not in m
    finally:
        eng.stop(timeout=2)


def test_megastep_from_concurrent_threads():
    """``solve`` runs on the callers' threads: concurrent latency submits
    serialise on the flight lock and each gets its own board's verdict."""
    import threading

    boards = [HARD_9[0], HARD_9[1], EASY_9, HARD_9[0], EASY_9, HARD_9[1]]
    eng = cpu_engine(config=FUSED_SMALL, max_batch=8, latency_mode=True, megastep=MS).start()
    out = [None] * len(boards)
    try:
        def fire(i):
            j = eng.submit(np.asarray(boards[i], np.int32))
            assert j.wait(120)
            out[i] = j

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(boards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
            assert not t.is_alive()
        for b, j in zip(boards, out):
            assert j is not None and j.solved, j and j.error
            assert np.array_equal(j.solution[np.asarray(b) > 0], np.asarray(b)[np.asarray(b) > 0])
        np.testing.assert_array_equal(out[0].solution, out[3].solution)
        np.testing.assert_array_equal(out[1].solution, out[5].solution)
        assert eng._megasteps[SUDOKU_9].metrics()["flights"] == len(boards)
    finally:
        eng.stop(timeout=2)
