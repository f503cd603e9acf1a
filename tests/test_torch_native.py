"""The port's native oracle and loader (``native/``): twins of ``tests/test_native.py``.

The library against the copied pure-Python oracle, on the same boards and
checks as the JAX package's own test (9 tests, 11 cases).  Parity with the
JAX package's library, ``cover_count``, the build's atomicity and the
copied sources are held in ``tests/test_torch_native_parity.py`` (the
pure-Python oracle alone takes most of a minute on HARD_9[2], so the two
files stay under a minute each).  Tolerance: exact equality.
"""

import numpy as np
import pytest

from distributed_sudoku_solver_tpu_torch import native
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16, Geometry
from distributed_sudoku_solver_tpu_torch.utils import oracle
from distributed_sudoku_solver_tpu_torch.utils.puzzles import (
    EASY_9,
    HARD_9,
    make_puzzle,
    random_solution,
)


@pytest.fixture(autouse=True)
def built():
    """The library builds here (g++ is part of the test image); decided at
    run time, never at import."""
    if not native.available():
        pytest.skip("no C++ toolchain in environment")


# -- twins of tests/test_native.py ----------------------------------------------


def test_solves_easy_and_matches_python_oracle():
    sol, nodes = native.solve(EASY_9)
    assert sol is not None
    np.testing.assert_array_equal(sol, oracle.solve_oracle(EASY_9))
    assert nodes > 0


@pytest.mark.parametrize("i", range(len(HARD_9)))
def test_hard_boards_bit_exact(i):
    sol, _ = native.solve(HARD_9[i])
    np.testing.assert_array_equal(sol, oracle.solve_oracle(HARD_9[i]))


def test_node_counts_match_python_oracle():
    _, py_nodes = oracle.solve_oracle(EASY_9, count_nodes=True)
    _, c_nodes = native.solve(EASY_9)
    assert c_nodes == py_nodes


def test_unsat_detection():
    bad = np.asarray(EASY_9).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    sol, _ = native.solve(bad)
    assert sol is None
    assert native.count_solutions(bad) == 0


def test_count_solutions_limits():
    empty = np.zeros((4, 4), dtype=np.int32)
    geom = Geometry(2, 2)
    assert native.count_solutions(empty, geom, limit=5) == 5
    assert native.count_solutions(EASY_9, limit=2) == 1


def test_validator_geometry_generic():
    assert native.is_valid_solution(random_solution(SUDOKU_9, 3))
    assert native.is_valid_solution(random_solution(SUDOKU_16, 4), SUDOKU_16)
    bad = random_solution(SUDOKU_9, 3)
    bad[0, 0] = bad[0, 1]
    assert not native.is_valid_solution(bad)


def test_batch_solve():
    grids = np.stack([EASY_9, *HARD_9])
    sols, results, nodes = native.solve_batch(grids)
    assert (results == 1).all()
    assert (nodes > 0).all()
    for i in range(grids.shape[0]):
        assert native.is_valid_solution(sols[i])


def test_16x16_puzzle_roundtrip():
    puzzle = make_puzzle(SUDOKU_16, seed=1, n_clues=170, unique=False)
    sol, _ = native.solve(puzzle, SUDOKU_16)
    assert sol is not None
    assert native.is_valid_solution(sol, SUDOKU_16)
    mask = puzzle != 0
    assert np.array_equal(sol[mask], puzzle[mask])


def test_malformed_grid_raises():
    bad = np.full((9, 9), 11, dtype=np.int32)
    with pytest.raises(ValueError):
        native.solve(bad)
