"""The port's native oracle and loader (``native/``) against the JAX package's.

Parity with the JAX package's library on the same boards (solutions, node
counts, ``count_solutions`` at limits 1, 2 and 10, ``solve_batch``);
``cover_count`` against the port's composite enumeration and the JAX
library; ``make_puzzle(unique=True)`` per seed; the build's atomicity under
threads and processes building at once; the copied sources equal to the JAX
package's byte for byte.  The twins of ``tests/test_native.py`` are in
``tests/test_torch_native.py``.  Tolerance: exact equality.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu import native as jnative
from distributed_sudoku_solver_tpu.models.nqueens import nqueens_cover as jnqueens_cover
from distributed_sudoku_solver_tpu_torch import native
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, SUDOKU_16
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.models.pentomino import pentomino_cover
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle

REPO = Path(__file__).resolve().parents[1]


def load_jax_native() -> bool:
    """Load the JAX package's library, the parity reference.  Its build is
    not atomic: test workers that start together each run ``g++ -o`` on one
    path, and a worker that loads the file while another still writes it
    marks the library failed for the rest of its process.  A failed load is
    retried here (resetting that mark) until the file is whole."""
    for _ in range(30):
        if jnative.available():
            return True
        jnative._build_failed = False
        time.sleep(1.0)
    return False


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain torch paths here are many small ops: under parallel test
    workers on a small host, torch's default thread pool per process
    oversubscribes the cores and slows them by orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def built():
    if not (native.available() and load_jax_native()):
        pytest.skip("no C++ toolchain in environment")


# -- parity with the JAX package's library ---------------------------------------


def _unsat_board():
    bad = np.asarray(EASY_9, np.int32).copy()
    bad[0, 0], bad[0, 1] = 5, 5
    return [bad]


BOARD_SETS = {
    "9x9": lambda: [make_puzzle(SUDOKU_9, 300 + s, n_clues=26, unique=False) for s in range(12)],
    "hard9": lambda: [np.asarray(h) for h in HARD_9],
    "16x16": lambda: [make_puzzle(SUDOKU_16, 40 + s, n_clues=180, unique=False)
                      for s in range(3)],
    "unsat": _unsat_board,
}


@pytest.mark.parametrize("which", sorted(BOARD_SETS))
def test_solve_and_counts_equal_the_jax_library(which):
    for board in BOARD_SETS[which]():
        board = np.asarray(board, np.int32)
        sol, nodes = native.solve(board)
        jsol, jnodes = jnative.solve(board)
        assert nodes == jnodes
        assert (sol is None) == (jsol is None)
        if sol is not None:
            np.testing.assert_array_equal(sol, jsol)
            assert native.is_valid_solution(sol) and jnative.is_valid_solution(jsol)
        for limit in (1, 2, 10):
            assert native.count_solutions(board, limit=limit) == jnative.count_solutions(
                board, limit=limit)
    if which == "unsat":
        assert sol is None and native.count_solutions(board, limit=10) == 0


def test_batch_solve_equals_the_jax_library():
    grids = np.stack([*BOARD_SETS["9x9"](), *HARD_9, *_unsat_board()]).astype(np.int32)
    got = native.solve_batch(grids)
    want = jnative.solve_batch(grids)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cover_count_equals_the_composite_enumeration_and_jax():
    """``cover_count`` reads the port's ``ExactCoverCSP`` fields directly;
    its count equals the port's composite ``count_all`` enumeration, and
    count and nodes equal the JAX library's on the JAX instance."""
    for problem, want in ((nqueens_cover(8), 92), (pentomino_cover(3, 20), 8)):
        count, nodes = native.cover_count(problem)
        cfg = SolverConfig(min_lanes=128, stack_slots=24, count_all=True, max_steps=50_000)
        res = solve_csp(problem.initial_state()[None], problem, cfg, device="cpu")
        assert bool(res.unsat[0]) and not bool(res.overflowed[0])
        assert count == int(res.sol_count[0]) > 0
        if want is not None:
            assert count == want
        assert nodes > 0
    assert native.cover_count(nqueens_cover(8)) == jnative.cover_count(jnqueens_cover(8))
    assert native.cover_count(nqueens_cover(8), limit=5)[0] == 5


def test_make_puzzle_unique_equals_jax_for_each_seed():
    from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as JSUDOKU_9
    from distributed_sudoku_solver_tpu.utils.puzzles import make_puzzle as jmake_puzzle

    for seed in range(1000, 1006):
        for clues in (22, 26, 30):
            got = make_puzzle(SUDOKU_9, seed, n_clues=clues)
            np.testing.assert_array_equal(got, jmake_puzzle(JSUDOKU_9, seed, n_clues=clues))
            assert native.count_solutions(got, limit=2) == 1


# -- the build -------------------------------------------------------------------


def _fresh(monkeypatch, build_dir):
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)


def _assert_one_whole_library(build_dir):
    names = sorted(p.name for p in build_dir.iterdir())
    assert len(names) == 1 and names[0].startswith("libcsp-") and names[0].endswith(".so"), names
    assert ".tmp" not in names[0]


def test_threads_building_at_once_build_once(tmp_path, monkeypatch):
    _fresh(monkeypatch, tmp_path)
    builds = []
    real = native._build

    def counting(path):
        builds.append(path)
        return real(path)

    monkeypatch.setattr(native, "_build", counting)
    barrier = threading.Barrier(4)
    seen = []

    def one():
        barrier.wait(10)
        seen.append(native.available())

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert seen == [True] * 4 and len(builds) == 1
    _assert_one_whole_library(tmp_path)
    sol, _ = native.solve(HARD_9[0])
    np.testing.assert_array_equal(sol, jnative.solve(HARD_9[0])[0])


def test_processes_building_at_once_leave_one_whole_library(tmp_path):
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from distributed_sudoku_solver_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "assert native.available()\n"
        "from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9\n"
        "print(native.solve(HARD_9[1])[1])\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert int(out) == jnative.solve(HARD_9[1])[1]
    _assert_one_whole_library(tmp_path)


def test_library_is_named_by_the_sources(tmp_path, monkeypatch):
    """An edited source names a new library, so a stale one never loads."""
    src = tmp_path / "src"
    src.mkdir()
    for f in native.SRC_DIR.glob("*.cc"):
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(native, "SRC_DIR", src)
    before = native.lib_path()
    with open(src / "solver.cc", "a") as f:
        f.write("\n// edited\n")
    assert native.lib_path() != before and native.lib_path().parent == native.BUILD_DIR


@pytest.mark.parametrize("name", ["solver.cc", "loader.cc"])
def test_sources_are_the_jax_packages_byte_for_byte(name):
    mine = REPO / "distributed_sudoku_solver_tpu_torch" / "native" / "src" / name
    theirs = REPO / "distributed_sudoku_solver_tpu" / "native" / "src" / name
    assert mine.read_bytes() == theirs.read_bytes()
    assert sorted(p.name for p in mine.parent.glob("*.cc")) == ["loader.cc", "solver.cc"]
