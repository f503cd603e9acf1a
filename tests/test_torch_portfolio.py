"""The port's portfolio racing (``serving/portfolio.py``) against the JAX package's.

Twins of ``tests/test_portfolio.py`` (the fleet-level race waits for the
port's cluster, ROADMAP A11), every engine on ``device="cpu"``.  The
demonstration family is {HARD_9[0], its digit-mirror d -> 10-d}:
propagation and MRV are digit-relabel-invariant, but DFS *value order* is
not, so the mirror exactly swaps the ascending/descending costs.  Verdicts,
step and node counts are held equal to the JAX package's on the same
boards and configs; which racer wins a race is timing, and is not compared.
Tolerance: exact equality.
"""

import time

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu import native as jnative
from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
from distributed_sudoku_solver_tpu.models.nqueens import nqueens_cover as jnqueens_cover
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.serving.portfolio import DEFAULT_PORTFOLIO as JPORTFOLIO
from distributed_sudoku_solver_tpu_torch import native
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, geometry_for_size
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.ops import cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import highest_bit, lowest_bit
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
from distributed_sudoku_solver_tpu_torch.serving.engine import SolverEngine
from distributed_sudoku_solver_tpu_torch.serving.portfolio import (
    DEFAULT_PORTFOLIO,
    NATIVE_COVER_MAX_ROWS,
    race,
    race_cover,
)
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain torch paths here are many small ops: under parallel test
    workers on a small host, torch's default thread pool per process
    oversubscribes the cores and slows them by orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mirror(board: np.ndarray) -> np.ndarray:
    return np.where(board > 0, 10 - board, 0).astype(np.int32)


def _cfg(rule: str) -> SolverConfig:
    # Single sequential lane: pure DFS, where value-order luck is maximal.
    return SolverConfig(lanes=1, stack_slots=64, branch=rule, max_steps=20_000, steal=False)


RULES = ("minrem", "minrem-desc", "first")


def _engine(**kw) -> SolverEngine:
    return SolverEngine(device="cpu", **kw).start()


def test_highest_bit():
    x = np.array([0, 1, 2, 3, 0b100110, 1 << 24], dtype=np.uint32)
    got = highest_bit(torch.from_numpy(x.view(np.int32))).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.array([0, 1, 2, 2, 0b100000, 1 << 24], dtype=np.uint32)
    )


def test_minrem_desc_solves_same_unique_solution():
    grids = np.stack(HARD_9).astype(np.int32)

    def batch_cfg(rule):
        return SolverConfig(min_lanes=1, stack_slots=64, branch=rule, max_steps=20_000,
                            steal=False)

    asc = solve_batch(grids, SUDOKU_9, batch_cfg("minrem"), device="cpu")
    desc = solve_batch(grids, SUDOKU_9, batch_cfg("minrem-desc"), device="cpu")
    assert bool(asc.solved.all()) and bool(desc.solved.all())
    assert torch.equal(asc.solution, desc.solution)


def _steps(board, rule) -> int:
    return int(solve_batch(board[None], SUDOKU_9, _cfg(rule), device="cpu").steps)


def test_portfolio_beats_every_single_config():
    """min-over-configs (what the race realizes) is strictly cheaper than
    every fixed config over the mirror family; every step count equals the
    JAX package's on the same board and config."""
    family = [np.asarray(HARD_9[0], np.int32), _mirror(np.asarray(HARD_9[0]))]
    steps = {rule: [_steps(b, rule) for b in family] for rule in RULES}
    portfolio_total = sum(min(steps[r][i] for r in RULES) for i in range(len(family)))
    for rule in RULES:
        assert portfolio_total < sum(steps[rule]), (
            f"portfolio {portfolio_total} does not beat {rule}: {steps}"
        )
    assert portfolio_total * 2 < min(sum(steps[r]) for r in RULES)
    jcfg = JSolverConfig(lanes=1, stack_slots=64, branch="minrem", max_steps=20_000,
                         steal=False)
    want = [int(jax_solve_batch(b[None], J9, jcfg).steps) for b in family]
    assert steps["minrem"] == want


def test_race_first_verdict_wins_and_cancels_losers():
    eng = _engine(chunk_steps=1, max_flights=8)
    try:
        board = np.asarray(HARD_9[0], np.int32)
        res = race(eng, board, [_cfg(r) for r in RULES], timeout=240)
        assert res.winner is not None
        assert res.winner.solved
        assert is_valid_solution(res.winner.solution)
        # Round-robin chunking is a fair scheduler: the fewest-steps config
        # (minrem) reaches its verdict first.
        assert res.winner_index == 0 and res.strategy == "minrem"
        for i, job in enumerate(res.jobs):
            assert job.wait(30)
            if i != res.winner_index:
                assert job.cancelled or job.solved or job.unsat
        deadline = time.monotonic() + 10
        while eng._flights and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not eng._flights
    finally:
        eng.stop(timeout=2)
    want = native.solve(board)[0]
    assert np.array_equal(res.winner.solution, want)


def test_race_unsat_verdict_wins():
    eng = _engine(chunk_steps=4, max_flights=8)
    try:
        bad = np.zeros((9, 9), np.int32)
        bad[0, 0] = bad[0, 1] = 7
        res = race(eng, bad, [_cfg("minrem"), _cfg("minrem-desc")], timeout=240)
        assert res.winner is not None
        assert res.winner.unsat and not res.winner.solved
    finally:
        eng.stop(timeout=2)


def test_default_portfolio_includes_fused_axis_and_races():
    """The default portfolio is the JAX package's (four racers, the last
    fused), and a race on a 9x9 board reaches the oracle's verdict with no
    fused downgrade (K2's plain version serves the fused racer here)."""
    assert list(DEFAULT_PORTFOLIO) == [SolverConfig.from_fields(c) for c in JPORTFOLIO]
    assert any(c.step_impl == "fused" for c in DEFAULT_PORTFOLIO)
    eng = _engine(max_flights=8)
    try:
        board = np.asarray(HARD_9[2], np.int32)
        res = race(eng, board, DEFAULT_PORTFOLIO, timeout=240)
        assert res.winner is not None and res.winner.solved
        assert np.array_equal(res.winner.solution, native.solve(board)[0])
        for job in res.jobs:
            assert job.wait(60) and job.error is None, job.error
        assert eng.metrics()["fused_downgrades"] == 0
    finally:
        eng.stop(timeout=2)


def test_fused_racer_misfit_downgrades_and_still_races(monkeypatch):
    """Where K2 cannot serve a fused racer's shape (forced here: the port's
    K2 takes every shape JAX's Mosaic kernel refused), the engine downgrades
    its flight to the composite step at launch, counted, and the racer
    serves correctly."""
    g25 = geometry_for_size(25)
    board = make_puzzle(g25, seed=11, n_clues=500, unique=False)  # propagation-easy
    configs = [
        SolverConfig(min_lanes=4, stack_slots=16, max_steps=4096),
        SolverConfig(min_lanes=4, stack_slots=64, max_steps=4096, step_impl="fused"),
    ]
    monkeypatch.setattr(cuda_step, "fused_lanes",
                        lambda *a: (_ for _ in ()).throw(ValueError("forced misfit")))
    eng = _engine(max_flights=8)
    try:
        res = race(eng, np.asarray(board, np.int32), configs, timeout=300)
        assert res.winner is not None and res.winner.solved
        fused_job = res.jobs[1]
        assert fused_job.wait(60)
        assert fused_job.error is None  # downgraded, not errored
        assert fused_job.solved or fused_job.cancelled
        assert eng.metrics()["fused_downgrades"] >= 1
    finally:
        eng.stop(timeout=2)


def test_cover_race_small_instance_finishes_at_native_speed():
    """n-queens 12 sits deep in the native DFS's winning regime: the race
    returns the native count long before the device entrant finishes, and
    count and nodes equal the JAX library's on the JAX instance."""
    from tests.test_torch_native_parity import load_jax_native

    assert load_jax_native() and native.available()
    problem = nqueens_cover(12)
    assert problem.n_rows <= NATIVE_COVER_MAX_ROWS
    t0 = time.monotonic()
    res = race_cover(problem, timeout=120.0, device="cpu")
    wall = time.monotonic() - t0
    assert res.count == 14_200  # OEIS A000170(12)
    assert res.complete
    assert res.winner == "native", f"device won?! {res}"
    assert (res.count, res.nodes) == jnative.cover_count(jnqueens_cover(12))
    assert wall < 30.0, f"race took {wall:.1f}s: the native result was not used"


def test_cover_race_device_covers_native_absence(monkeypatch):
    """With the native entrant unavailable, the device entrant alone must
    still produce the exact count (n-queens 5)."""
    monkeypatch.setattr(native, "available", lambda: False)
    res = race_cover(
        nqueens_cover(5),
        config=SolverConfig(min_lanes=16, stack_slots=16, count_all=True, max_steps=4096),
        timeout=300.0,
        device="cpu",
    )
    assert res.winner == "device"
    assert res.count == 10  # A000170(5)
    assert res.complete
    assert res.nodes > 0


def test_cover_race_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        race_cover(nqueens_cover(5), timeout=10.0)


# -- the mirror partition --------------------------------------------------------


def _run(board, rule):
    r = solve_batch(board[None], SUDOKU_9, _cfg(rule), device="cpu")
    assert bool(r.solved[0])
    return int(r.nodes[0]), int(r.steps), r.solution[0].numpy()


def test_minrem_desc_mirror_explores_the_reflected_tree_exactly():
    """d -> 10-d reverses value order but preserves MRV counts and cell
    tie-breaks, so ``minrem-desc`` on the mirror walks the EXACT tree
    ``minrem`` walks on the original: same nodes, same steps (the JAX
    package's too), mirrored solution."""
    b = np.asarray(HARD_9[0], np.int32)
    mb = _mirror(b)
    n_asc, s_asc, sol_asc = _run(b, "minrem")
    n_dm, s_dm, sol_dm = _run(mb, "minrem-desc")
    assert (n_asc, s_asc) == (n_dm, s_dm)
    np.testing.assert_array_equal(_mirror(sol_asc), sol_dm)
    n_desc, s_desc, _ = _run(b, "minrem-desc")
    n_am, s_am, _ = _run(mb, "minrem")
    assert (n_desc, s_desc) == (n_am, s_am)
    assert n_asc != n_desc
    jres = jax_solve_batch(b[None], J9, JSolverConfig(lanes=1, stack_slots=64,
                                                      branch="minrem-desc",
                                                      max_steps=20_000, steal=False))
    assert (n_desc, s_desc) == (int(np.asarray(jres.nodes)[0]), int(jres.steps))


def test_value_orders_partition_subtrees_no_duplicates():
    """Exhaustive enumeration visits every model exactly once under EITHER
    value order: asc and desc report the identical exact count, which is
    the native DFS's."""
    few = np.asarray(EASY_9, np.int32).copy()
    rng = np.random.default_rng(3)
    idx = np.flatnonzero(few.ravel())
    few.ravel()[rng.choice(idx, size=4, replace=False)] = 0  # 62 solutions

    def cfg(rule):
        return SolverConfig(min_lanes=8, stack_slots=32, branch=rule, max_steps=100_000,
                            count_all=True)

    asc = solve_batch(few[None], SUDOKU_9, cfg("minrem"), device="cpu")
    desc = solve_batch(few[None], SUDOKU_9, cfg("minrem-desc"), device="cpu")
    assert not bool(asc.overflowed[0]) and not bool(desc.overflowed[0])
    assert int(asc.sol_count[0]) == int(desc.sol_count[0]) == 62
    assert native.count_solutions(few, limit=1000) == 62


def test_branch_site_guess_sets_are_disjoint():
    """At a shared branch state the two orders pick the SAME cell (the JAX
    package's choice too) but disjoint first guesses (lowest vs highest
    candidate bit)."""
    from distributed_sudoku_solver_tpu.ops import ordering as jordering
    from distributed_sudoku_solver_tpu.ops.pallas_step import branch_onehot_full

    n = 9
    g = np.asarray(HARD_9[0], np.int64)
    m = np.full((n, n), (1 << n) - 1, dtype=np.int64)
    nz = g > 0
    m[nz] = np.int64(1) << (g[nz] - 1)
    m, status = jordering._np_propagate(m, J9)
    assert status == "open"

    cand = torch.from_numpy(m.astype(np.int32)[None])
    one_asc = SudokuCSP(SUDOKU_9, "minrem")._branch_cell_onehot(cand)[0].numpy()
    one_desc = SudokuCSP(SUDOKU_9, "minrem-desc")._branch_cell_onehot(cand)[0].numpy()
    np.testing.assert_array_equal(one_asc, one_desc)
    assert one_asc.sum() == 1
    want = np.asarray(branch_onehot_full(m[..., None].astype(np.uint32), J9, "minrem"))[..., 0]
    np.testing.assert_array_equal(one_asc, want.astype(bool))

    r, c = np.argwhere(one_asc)[0]
    cell = torch.tensor([int(m[r, c])], dtype=torch.int32)
    low, high = int(lowest_bit(cell)[0]), int(highest_bit(cell)[0])
    assert low & high == 0
    assert (low | high) & ~int(m[r, c]) == 0
