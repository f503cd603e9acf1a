"""The port's serving engine (``serving/engine.py``) against the JAX package's.

Twins of ``tests/test_engine.py``: chunked flights, mid-flight cancel,
head-of-line fairness, snapshot / shed controls, multi-root jobs, fused
flights and the fused launch policy; plus parity with the JAX package on
the same boards and configs.  Tolerance: exact equality on every integer
field.  A composite flight is held bit-exact against JAX's ``solve_batch``
on every field of ``FIELDS``; fused flights, whose step counts are an
approximation in both packages, are held verdict-equal with exact
``count_all`` counts.  Every engine here runs on the CPU (``device="cpu"``);
``tests/test_torch_serving_cuda.py`` holds the engine on a card against
the CPU port.
"""

import dataclasses
import functools
import random
import threading
import time

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.pallas_step import max_fused_lanes as jax_max_fused_lanes
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.models.geometry import geometry_for_size as jgeometry
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, geometry_for_size
from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops import cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.serving import engine as engine_mod
from distributed_sudoku_solver_tpu_torch.serving.engine import Job, SolverEngine, host_fetch
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution, solve_oracle
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle

SMALL = SolverConfig(min_lanes=8, stack_slots=16)
FUSED_SMALL = SolverConfig(min_lanes=8, stack_slots=16, step_impl="fused", fused_steps=2)
FIELDS = ("solution", "solved", "unsat", "overflowed", "nodes", "sol_count", "steps",
          "sweeps", "expansions", "steals")


@functools.lru_cache(maxsize=None)
def hard9_solutions() -> np.ndarray:
    """HARD_9's unique solutions from the JAX package's composite solve
    (the pure-Python oracle takes most of a minute on HARD_9[2])."""
    res = jax_solve_batch(np.stack(HARD_9).astype(np.int32), jgeometry(9),
                          JSolverConfig(min_lanes=8, stack_slots=16))
    assert np.asarray(res.solved).all()
    return np.asarray(res.solution)


def bad_board():
    bad = np.zeros((9, 9), np.int32)
    bad[0, 0] = bad[0, 1] = 5
    return bad


def wait_for(pred, timeout=30.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def cpu_engine(**kw) -> SolverEngine:
    return SolverEngine(device="cpu", **kw)


@pytest.fixture(autouse=True)
def port_lock_witness():
    """The port's lock hierarchy, armed over each test (the session-wide
    witness of ``tests/conftest.py`` is the JAX package's)."""
    with lockdep.installed(lockdep.manifest_witness(strict=True)) as w:
        yield w
    assert w.violations == [], w.violations


@pytest.fixture
def engine():
    eng = cpu_engine(config=SMALL, max_batch=8).start()
    yield eng
    eng.stop(timeout=2)


def test_flight_solves_and_counts(engine):
    jobs = [engine.submit(p) for p in HARD_9]
    for j, want in zip(jobs, hard9_solutions()):
        assert j.wait(60)
        assert j.solved
        assert is_valid_solution(j.solution)
        np.testing.assert_array_equal(j.solution, want)  # unique boards
    assert engine.stats()["solved"] == len(HARD_9)
    assert engine.stats()["validations"] > 0


def test_flight_unsat(engine):
    j = engine.submit(bad_board())
    assert j.wait(60)
    assert j.unsat and not j.solved


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_mid_flight_cancel_frees_device(cfg):
    eng = cpu_engine(config=cfg, max_batch=8, chunk_steps=1, handicap_s=0.1).start()
    try:
        j = eng.submit(HARD_9[0])
        assert wait_for(lambda: len(eng._flights) > 0, timeout=30)
        eng.cancel(j.uuid)
        t0 = time.monotonic()
        assert j.wait(30), "cancelled job must resolve promptly"
        assert j.cancelled and not j.solved and not j.unsat
        assert wait_for(lambda: len(eng._flights) == 0, timeout=20)
        assert time.monotonic() - t0 < 25
    finally:
        eng.stop(timeout=2)


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_no_head_of_line_blocking(cfg):
    eng = cpu_engine(config=cfg, max_batch=8, chunk_steps=1, handicap_s=0.25,
                     max_flights=4).start()
    try:
        hard = eng.submit(HARD_9[0])
        assert wait_for(lambda: len(eng._flights) > 0, timeout=30)
        easy = eng.submit(EASY_9)
        assert easy.wait(30), "easy job starved behind the hard flight"
        assert easy.solved
        assert not hard.done.is_set(), "the hard flight finished first"
        assert hard.wait(120) and hard.solved
    finally:
        eng.stop(timeout=2)


def test_fixed_non_pow2_lane_config():
    eng = cpu_engine(config=SolverConfig(lanes=6, stack_slots=16), max_batch=8).start()
    try:
        jobs = [eng.submit(p) for p in HARD_9] + [eng.submit(EASY_9)]
        for j in jobs:
            assert j.wait(120)
            assert j.solved, j.error
    finally:
        eng.stop(timeout=2)


def _snapshot_while_flying(eng, j):
    assert wait_for(lambda: len(eng._flights) > 0, timeout=30)
    snap = None
    deadline = time.monotonic() + 20
    while snap is None and time.monotonic() < deadline:
        snap = eng.snapshot_rows(j.uuid, timeout=5)
        if j.done.is_set():
            break
    return snap


@pytest.mark.parametrize("cfg", [SMALL, FUSED_SMALL], ids=["xla", "fused"])
def test_snapshot_and_resume_roots(cfg):
    slow = cpu_engine(config=cfg, max_batch=8, chunk_steps=1, handicap_s=0.1).start()
    try:
        warm = slow.submit(EASY_9)
        assert warm.wait(60)
        j = slow.submit(HARD_9[1])
        snap = _snapshot_while_flying(slow, j)
        assert snap is not None, "no snapshot while job in flight"
        rows, nodes, shed_parts, job_cfg = snap
        assert shed_parts == 0
        assert job_cfg["branch"] == cfg.branch and job_cfg["step_impl"] == cfg.step_impl
        assert rows.dtype == np.uint32 and rows.ndim == 3 and rows.shape[0] >= 1
        assert j.wait(120) and j.solved
        jr = slow.submit_roots(rows, j.geom, config=cfg)
        assert jr.wait(120) and jr.solved, jr.error
        np.testing.assert_array_equal(jr.solution, j.solution)
    finally:
        slow.stop(timeout=2)


def test_stop_drains_pending_jobs():
    eng = cpu_engine(config=SMALL, max_batch=8, chunk_steps=1, handicap_s=0.2).start()
    warm = eng.submit(EASY_9)
    assert warm.wait(60)
    inflight = eng.submit(HARD_9[1])
    assert wait_for(lambda: len(eng._flights) > 0, timeout=30)
    queued = eng.submit(HARD_9[0])
    eng.stop(timeout=10)
    assert inflight.wait(5), "in-flight job stranded by stop()"
    assert queued.wait(5), "queued job stranded by stop()"
    for j in (inflight, queued):
        assert j.solved or j.error == "engine stopped"


def test_flight_failure_resolves_jobs_and_loop_survives():
    eng = cpu_engine(config=SolverConfig(lanes=2, stack_slots=4), max_batch=8).start()
    try:
        bad_roots = np.ones((2 * (1 + 4) + 1, 9, 9), np.uint32)  # > capacity
        j = eng.submit_roots(bad_roots, geometry_for_size(9))
        assert j.wait(60)
        assert j.error and not j.solved
        ok = eng.submit(EASY_9)
        assert ok.wait(60) and ok.solved, "loop died after a failed flight"
    finally:
        eng.stop(timeout=2)


def test_legacy_solve_fn_failure_resolves_jobs():
    def boom(grids, geom, cfg):
        raise RuntimeError("backend exploded")

    eng = cpu_engine(solve_fn=boom, batch_window_s=0.001).start()
    try:
        j = eng.submit(EASY_9)
        assert j.wait(30)
        assert j.error and "backend exploded" in j.error
    finally:
        eng.stop(timeout=2)


def test_legacy_solve_fn_path_matches_flights():
    """The ``solve_fn`` override keeps the one-dispatch path: the port's
    ``solve_batch`` as the backend solves the same boards to the same
    (unique) solutions as the flights."""
    from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch

    eng = cpu_engine(solve_fn=lambda g, geom, c: solve_batch(g, geom, c, device="cpu"),
                     config=SMALL, batch_window_s=0.05).start()
    try:
        jobs = [eng.submit(p) for p in HARD_9]
        for j, want in zip(jobs, hard9_solutions()):
            assert j.wait(60) and j.solved, j.error
            np.testing.assert_array_equal(j.solution, want)
        assert eng.stats()["jobs_done"] == len(HARD_9)
    finally:
        eng.stop(timeout=2)


def test_concurrent_control_surface_stress():
    eng = cpu_engine(config=SMALL, max_batch=16, chunk_steps=2).start()
    try:
        stop = time.monotonic() + 3.0
        jobs: list = []
        jobs_lock = threading.Lock()
        errors: list = []

        def submitter():
            rng = random.Random(threading.get_ident())
            while time.monotonic() < stop:
                j = eng.submit(HARD_9[rng.randrange(len(HARD_9))])
                with jobs_lock:
                    jobs.append(j)
                if rng.random() < 0.3:
                    eng.cancel(j.uuid)
                time.sleep(0.02 + rng.random() * 0.03)

        def controller():
            rng = random.Random(threading.get_ident() * 31)
            while time.monotonic() < stop:
                try:
                    op = rng.random()
                    if op < 0.4:
                        with jobs_lock:
                            j = jobs[rng.randrange(len(jobs))] if jobs else None
                        if j is not None:
                            eng.snapshot_rows(j.uuid, timeout=1.0)
                    elif op < 0.7:
                        eng.shed_work(k=2, timeout=1.0)
                    else:
                        eng.run_exclusive(lambda: 42, timeout=1.0)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                time.sleep(rng.random() * 0.01)

        threads = [threading.Thread(target=submitter) for _ in range(3)] + [
            threading.Thread(target=controller) for _ in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive(), "stress thread wedged"
        assert not errors, errors[:3]
        with jobs_lock:
            all_jobs = list(jobs)
        assert all_jobs
        for j in all_jobs:
            assert j.wait(120), f"job lost under stress: {j.uuid}"
            assert j.solved or j.cancelled or j.exhausted or j.error, j.uuid
        final = eng.submit(EASY_9)
        assert final.wait(60) and final.solved
    finally:
        eng.stop(timeout=2)


def test_shed_work_marks_exhaustion_unreliable():
    eng = cpu_engine(config=SolverConfig(min_lanes=2, stack_slots=16, branch="first"),
                     max_batch=8, chunk_steps=1, handicap_s=0.1).start()
    try:
        warm = eng.submit(EASY_9)
        assert warm.wait(60)
        j = eng.submit(HARD_9[1])
        shed = None
        deadline = time.monotonic() + 30
        while shed is None and time.monotonic() < deadline:
            if j.done.is_set():
                break
            shed = eng.shed_work(k=2, timeout=5)
        assert shed is not None, "the search resolved before any stack rows appeared"
        uuid, rows, job_cfg = shed
        assert job_cfg["branch"] == "first"
        assert uuid == j.uuid and rows.shape[0] >= 1 and rows.dtype == np.uint32
        assert j.wait(120)
        assert j.shed_parts == 1
        if not j.solved:
            assert j.exhausted and not j.unsat
        else:
            assert is_valid_solution(j.solution)
    finally:
        eng.stop(timeout=2)


def test_fused_flight_solves_and_verdicts():
    eng = cpu_engine(config=FUSED_SMALL, max_batch=8).start()
    try:
        jobs = [eng.submit(p) for p in HARD_9]
        ju = eng.submit(bad_board())
        for j, want in zip(jobs, hard9_solutions()):
            assert j.wait(120) and j.solved, j.error
            np.testing.assert_array_equal(j.solution, want)
        assert ju.wait(120)
        assert ju.unsat and not ju.solved
        assert eng.stats()["solved"] == len(HARD_9)
        assert eng.stats()["validations"] > 0
    finally:
        eng.stop(timeout=2)


def test_fused_and_xla_jobs_share_one_engine():
    eng = cpu_engine(config=SMALL, max_batch=8).start()
    try:
        jf = eng.submit(HARD_9[0], config=FUSED_SMALL)
        jx = eng.submit(HARD_9[0])
        assert jf.wait(120) and jf.solved, jf.error
        assert jx.wait(120) and jx.solved, jx.error
        np.testing.assert_array_equal(jf.solution, jx.solution)
    finally:
        eng.stop(timeout=2)


def test_oversized_fused_group_splits_before_downgrading():
    """The launch decisions against JAX's: JAX caps fused flights at the
    measured scoped-VMEM boundaries (16x16 S=128 and 25x25 S=32 at 128
    lanes, 25x25 S=64 not at all); K2 keeps its stacks in device memory,
    so the port's cap is the kernel's int lane range at every shape.  The
    130-job group below is one fused flight in both, with no downgrade."""
    assert jax_max_fused_lanes(9, 32) == 1 << 30
    assert jax_max_fused_lanes(16, 128) == 128
    assert jax_max_fused_lanes(25, 32) == 128
    assert jax_max_fused_lanes(25, 64) == 0
    cap = cuda_step.max_fused_lanes(9, 32)
    assert cap >= 1 << 30 and cap % 128 == 0
    for n, s in ((16, 128), (25, 32), (25, 64)):
        assert cuda_step.max_fused_lanes(n, s) == cap  # differs from JAX
    assert cuda_step.max_fused_lanes(9, 0) == 0  # no stack: nothing fits
    cfg = SolverConfig(stack_slots=32, step_impl="fused", fused_steps=2)
    eng = cpu_engine(config=cfg, max_batch=256, max_flights=8).start()
    try:
        jobs = [eng.submit(EASY_9) for _ in range(130)]
        for j in jobs:
            assert j.wait(300), j.error
            assert j.solved and j.error is None, j.error
        assert eng.metrics()["fused_downgrades"] == 0
    finally:
        eng.stop(timeout=2)


def test_pinned_wide_fused_lanes_clamp_to_serving_width():
    """A pinned 256-lane fused config flies as-is (JAX: also as-is at 9x9
    S=32; where JAX clamps to 128 lanes, K2 takes the full width)."""
    cfg = SolverConfig(lanes=256, stack_slots=32, step_impl="fused", fused_steps=2)
    eng = cpu_engine(config=cfg, max_batch=8)
    seen = []
    start = eng._start_flight
    eng._start_flight = lambda geom, c, jobs: (seen.append(c), start(geom, c, jobs))
    eng.start()
    try:
        j = eng.submit(EASY_9)
        assert j.wait(300), j.error
        assert j.solved and j.error is None, j.error
        assert eng.metrics()["fused_downgrades"] == 0
        assert seen and seen[0].lanes == 256 and seen[0].step_impl == "fused"
    finally:
        eng.stop(timeout=2)


def test_packed_roots_fused_flight_clamps_like_grid_jobs():
    cfg = SolverConfig(lanes=256, stack_slots=32, step_impl="fused", fused_steps=2)
    roots = encode_grid(torch.from_numpy(np.asarray(EASY_9)[None]), SUDOKU_9).numpy()
    eng = cpu_engine(config=cfg, max_batch=8).start()
    try:
        j = eng.submit_roots(roots.view(np.uint32), SUDOKU_9)
        assert j.wait(300), j.error
        assert j.solved and j.error is None, j.error
        assert eng.metrics()["fused_downgrades"] == 0
    finally:
        eng.stop(timeout=2)


def test_fused_flight_vmem_misfit_downgrades_to_composite(monkeypatch):
    """25x25 at S=64 is past JAX's measured VMEM cap, so the JAX engine
    downgrades that flight to the composite step; K2 serves it fused (no
    downgrade).  The verdicts agree: solved by both, the port's solution
    valid and keeping its givens, JAX's composite solve solving it too.
    A forced misfit (``fused_lanes`` raising) still takes the ladder:
    counted, served on the composite step."""
    g25 = geometry_for_size(25)
    board = make_puzzle(g25, seed=7, n_clues=545, unique=False).astype(np.int32)
    assert jax_max_fused_lanes(25, 64) == 0  # JAX: downgrade
    jres = jax_solve_batch(board[None], jgeometry(25), JSolverConfig(min_lanes=8, stack_slots=16))
    eng = cpu_engine(config=SolverConfig(lanes=256, stack_slots=64, step_impl="fused"),
                     max_batch=8).start()
    try:
        j = eng.submit(board, geom=g25)
        assert j.wait(240), j.error
        assert j.error is None and j.solved == bool(np.asarray(jres.solved)[0]) is True
        assert is_valid_solution(j.solution, g25)
        assert np.array_equal(j.solution[board > 0], board[board > 0])
        assert eng.metrics()["fused_downgrades"] == 0  # differs from JAX
        monkeypatch.setattr(cuda_step, "fused_lanes",
                            lambda *a: (_ for _ in ()).throw(ValueError("forced misfit")))
        k = eng.submit(EASY_9, config=FUSED_SMALL)
        assert k.wait(60) and k.solved, k.error
        assert eng.metrics()["fused_downgrades"] == 1
    finally:
        eng.stop(timeout=2)


def test_fused_occupancy_histogram_on_metrics():
    eng = cpu_engine(config=FUSED_SMALL, max_batch=8, chunk_steps=4).start()
    try:
        jobs = [eng.submit(p) for p in HARD_9]
        for j in jobs:
            assert j.wait(120)
            assert j.solved
        occ = eng.metrics().get("fused_lane_occupancy")
        assert occ is not None
        assert occ["bucket_pct"] == 10
        assert len(occ["counts"]) == 10
        assert sum(occ["counts"]) > 0
        assert occ["chunks"] > 0
        assert 0.0 <= occ["mean_pct"] <= 100.0
    finally:
        eng.stop(timeout=2)


def test_composite_engine_has_no_occupancy_histogram():
    eng = cpu_engine(config=SMALL, max_batch=4).start()
    try:
        j = eng.submit(EASY_9)
        assert j.wait(60) and j.solved
        assert "fused_lane_occupancy" not in eng.metrics()
    finally:
        eng.stop(timeout=2)


# -- parity with the JAX package ----------------------------------------------


def _drive(eng, geom, boards, cfg):
    """One flight of ``boards`` launched and driven by hand (the loop never
    starts, so the chunk schedule is deterministic); returns the jobs and
    the SolveResult the flight finalized."""
    finals = []
    orig = engine_mod._finalize

    def capture(state):
        res = orig(state)
        finals.append(res)
        return res

    jobs = [Job(uuid=f"j{i}", grid=np.asarray(b, np.int32), geom=geom)
            for i, b in enumerate(boards)]
    eng._launch_flights(geom, cfg, jobs)
    fl = eng._flights.pop()
    engine_mod._finalize = capture
    try:
        for _ in range(10_000):
            if eng._advance_flight(fl):
                break
    finally:
        engine_mod._finalize = orig
    return jobs, finals[0]


@pytest.mark.parametrize("n,count,kw", [
    (9, 4, dict(min_lanes=8, stack_slots=16)),
    (9, 8, dict(min_lanes=16, stack_slots=8, branch="mixed", rules="extended")),
    (6, 4, dict(min_lanes=4, stack_slots=16, branch="first", rules="subsets")),
], ids=["9x9-minrem", "9x9-mixed-extended", "6x6-first-subsets"])
def test_composite_flight_bit_exact_with_jax_solve_batch(n, count, kw):
    """A composite flight of a power-of-two job count is seeded as JAX's
    ``solve_batch`` seeds the same boards, and its chunks are invariant:
    the finalized flight equals JAX's result on every field."""
    geom = geometry_for_size(n)
    boards = [make_puzzle(geom, 40 + i, n_clues=int(n * n * 0.3), unique=False)
              for i in range(count)]
    if n == 9:
        boards[0] = HARD_9[1]
    cfg = SolverConfig(**kw)
    jobs, res = _drive(cpu_engine(config=cfg, chunk_steps=3), geom, boards, cfg)
    want = jax_solve_batch(np.stack(boards).astype(np.int32), jgeometry(n), JSolverConfig(**kw))
    for f in FIELDS:
        assert np.array_equal(getattr(res, f).numpy(), np.asarray(getattr(want, f))), f
    for i, j in enumerate(jobs):
        assert j.solved == bool(np.asarray(want.solved)[i])
        assert j.nodes == int(np.asarray(want.nodes)[i])
        np.testing.assert_array_equal(j.solution, np.asarray(want.solution)[i])


def test_fused_flights_verdict_equal_with_exact_counts():
    """Fused flights (and composite ones) against JAX: the same verdicts,
    and exact ``count_all`` counts (the empty 4x4 has 288 completions, the
    board below 8)."""
    sol = solve_oracle(HARD_9[0])
    multi = np.where(np.isin(sol, (1, 2)), 0, sol).astype(np.int32)
    jres = jax_solve_batch(np.stack([multi]), jgeometry(9),
                           JSolverConfig(min_lanes=8, stack_slots=16, count_all=True))
    want_count = int(np.asarray(jres.sol_count)[0])
    assert want_count == 8
    eng = cpu_engine(config=FUSED_SMALL, max_batch=8).start()
    try:
        boards = list(HARD_9) + [EASY_9, bad_board()]
        jobs = [eng.submit(b) for b in boards]
        counts = [
            eng.submit(multi, config=dataclasses.replace(FUSED_SMALL, count_all=True)),
            eng.submit(np.zeros((4, 4), np.int32),
                       config=dataclasses.replace(FUSED_SMALL, count_all=True)),
            eng.submit(multi, config=dataclasses.replace(SMALL, count_all=True)),
        ]
        jv = jax_solve_batch(np.stack(boards).astype(np.int32), jgeometry(9),
                             JSolverConfig(min_lanes=8, stack_slots=16))
        for i, j in enumerate(jobs):
            assert j.wait(120), j.error
            assert (j.solved, j.unsat) == (bool(np.asarray(jv.solved)[i]),
                                           bool(np.asarray(jv.unsat)[i]))
        for j, want in zip(counts, (want_count, 288, want_count)):
            assert j.wait(120), j.error
            assert j.sol_count == want and j.unsat  # enumeration complete
            assert is_valid_solution(j.solution)
    finally:
        eng.stop(timeout=2)


def test_host_fetch_one_transfer_and_seams(monkeypatch):
    """``host_fetch`` returns the matching numpy tree (the NamedTuple type
    kept, dtypes and 0-d shapes kept), crosses all tensors in one
    ``.cpu()`` copy, fires its fault site and sleeps its floor."""
    from distributed_sudoku_solver_tpu_torch.ops.frontier import init_frontier
    from distributed_sudoku_solver_tpu_torch.serving import faults

    state = init_frontier(encode_grid(torch.from_numpy(np.stack(HARD_9)), SUDOKU_9), SMALL)
    copies = []
    orig_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (
        copies.append(self.shape), orig_cpu(self, *a, **k))[1])
    inj = faults.FaultInjector(faults.FaultSchedule.at({}))
    with faults.injected(inj):
        t0 = time.monotonic()
        host = host_fetch(state, floor_s=0.05, tag="control")
        assert time.monotonic() - t0 >= 0.05
    assert inj.metrics()["dispatches"] == {"fetch.control": 1}
    assert len(copies) == 1
    assert type(host).__name__ == "Frontier"
    for name, a, b in zip(state._fields, state, host):
        assert isinstance(b, np.ndarray), name
        assert b.dtype == a.numpy().dtype and b.shape == tuple(a.shape), name
        np.testing.assert_array_equal(b, a.numpy(), err_msg=name)
    pair = host_fetch((state.steps, 7), tag="event")
    assert pair[1] == 7 and pair[0].shape == () and int(pair[0]) == 0


def test_engine_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from distributed_sudoku_solver_tpu_torch.serving.http import StandaloneNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolverEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StandaloneNode()
    assert SolverEngine(device="cpu").device.type == "cpu"
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import FrontDoorConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolverEngine(frontdoor=FrontDoorConfig())
    assert SolverEngine(device="cpu", frontdoor=FrontDoorConfig()).frontdoor is not None


def test_frontdoor_routes_cache_propagation_native_and_device():
    """``SolverEngine(device="cpu", frontdoor=FrontDoorConfig())`` routes
    each submit as the JAX engine does: a hard board to a device flight, its
    transformed repeat to the cache, an easy-open board to the native race,
    EASY_9 and an unsat board to the propagation probe; stats count every
    answered job; ``frontdoor=False`` bypasses the door."""
    from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9 as G9
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor.canonical import (
        apply_transform,
        random_transform,
    )
    from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import FrontDoorConfig

    eng = cpu_engine(config=SMALL, max_batch=8, frontdoor=FrontDoorConfig()).start()
    try:
        hard = np.asarray(HARD_9[0])
        tr = random_transform(G9, np.random.default_rng(5))
        boards = [hard, apply_transform(hard, tr), make_puzzle(G9, 123, n_clues=30),
                  np.asarray(EASY_9), bad_board()]
        jobs = [eng.submit(b) for b in boards[:1]]
        assert jobs[0].wait(120)
        jobs += [eng.submit(b) for b in boards[1:]]
        for j in jobs:
            assert j.wait(120), j.error
        assert [j.route for j in jobs] == ["device", "cache", "native", "propagation",
                                          "propagation"]
        assert [j.solved for j in jobs] == [True] * 4 + [False] and jobs[-1].unsat
        assert np.array_equal(jobs[0].solution, hard9_solutions()[0])
        assert np.array_equal(jobs[1].solution, apply_transform(jobs[0].solution, tr))
        fd = eng.metrics()["frontdoor"]
        assert fd["routes"] == {"cache": 1, "propagation": 2, "native": 1, "device": 1}
        assert fd["probe"] == {"solved": 1, "unsat": 1, "easy": 1, "hard": 1}
        assert eng.stats()["jobs_done"] == 5 and eng.stats()["solved"] == 4
        direct = eng.submit(hard, frontdoor=False)
        assert direct.wait(120) and direct.solved and direct.route is None
        assert eng.metrics()["frontdoor"]["routes"]["device"] == 1
    finally:
        eng.stop(timeout=5)


def test_drain_journals_unstarted_work_and_recover_replays_it(tmp_path):
    """The durable lifecycle on the port's engine: drain closes admission
    (EngineDraining), journals the unstarted jobs and leaves their WAL
    entries accepted-only; an engine restarted over the same directory
    replays them through the normal submit seam to real verdicts."""
    from distributed_sudoku_solver_tpu_torch.serving.engine import EngineDraining
    from distributed_sudoku_solver_tpu_torch.serving.journal import Journal

    jr = Journal(str(tmp_path), fsync_interval_s=0.01)
    eng = cpu_engine(config=SMALL, max_batch=8, journal=jr)  # never started
    try:
        queued = [eng.submit(b, job_uuid=f"queued-{i}") for i, b in enumerate(HARD_9)]
        summary = eng.drain(timeout=0.1)
        assert summary["state"] == "drained" and summary["journaled"] == 3
        for q in queued:
            assert q.done.is_set() and "draining" in q.error
        with pytest.raises(EngineDraining) as ei:
            eng.submit(EASY_9)
        assert ei.value.state == "drained"
        assert eng.metrics()["lifecycle"]["state"] == 2
        jr.sync_now()
        assert {ev["uuid"] for ev in jr.unresolved()} == {f"queued-{i}" for i in range(3)}
    finally:
        eng.stop()
        jr.shutdown()
    jr2 = Journal(str(tmp_path), fsync_interval_s=0.01)
    eng2 = cpu_engine(config=SMALL, max_batch=8, journal=jr2).start()
    try:
        assert eng2.recover() == 3
        assert eng2.metrics()["lifecycle"]["recovered_jobs"] == 3
        for i, want in enumerate(hard9_solutions()):
            j = eng2._dup_job(f"queued-{i}")
            assert j is not None and j.wait(60) and j.solved
            np.testing.assert_array_equal(j.solution, want)
        jr2.sync_now()
        assert jr2.unresolved() == []
    finally:
        eng2.stop()
        jr2.shutdown()
