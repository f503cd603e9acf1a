"""The lane-sharded fused solve (``parallel/fused_sharded.py``) against the
JAX package's.

K2's and K3's plain versions run on every shard here (the CPU has no
kernels); JAX runs its Pallas kernels in interpret mode on its eight CPU
devices.  The cases of ``tests/test_fused_sharded.py`` come first, then
``test_count_all_fused_sharded_psum_exact`` and
``test_fused_cover_sharded_on_mesh``, then parity with JAX at 1, 2, 4 and
8 shards.  Held to JAX's fused contract: verdicts and solutions equal,
``count_all`` counts exact; every other field equal too, but ``sweeps``,
which the port sums per lane (``ops/cuda_step.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
from distributed_sudoku_solver_tpu.models.nqueens import nqueens_cover as jax_nqueens
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.parallel import fused_sharded as jfs
from distributed_sudoku_solver_tpu.parallel import make_mesh as jax_make_mesh
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_4, SUDOKU_9
from distributed_sudoku_solver_tpu_torch.models.nqueens import (
    decode_queens,
    is_valid_queens,
    nqueens_cover,
)
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover, cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
from distributed_sudoku_solver_tpu_torch.parallel import (
    make_mesh,
    solve_batch_fused_sharded,
    solve_batch_sharded,
    solve_csp_fused_sharded,
    solve_csp_sharded,
    virtual_devices,
)
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import EASY_9, HARD_9, make_puzzle

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _eight_shards():
    with virtual_devices(8):
        yield


def _cfg(**kw):
    kw.setdefault("min_lanes", 16)
    kw.setdefault("stack_slots", 16)
    kw.setdefault("max_steps", 4096)
    return SolverConfig(step_impl="fused", **kw)


def _unsat_board():
    bad = np.asarray(EASY_9).copy()
    bad[0, 0] = bad[0, 1] = 5
    return bad


def _mesh(n_dev: int):
    return make_mesh([CPU] * n_dev)


# -- the cases of tests/test_fused_sharded.py ---------------------------------------


def test_fused_sharded_matches_single_device():
    from distributed_sudoku_solver_tpu_torch import native

    grids = np.stack([EASY_9, *HARD_9])
    res1 = solve_batch(grids, SUDOKU_9, _cfg(), device="cpu")
    res8 = solve_batch_fused_sharded(grids, SUDOKU_9, _cfg(), mesh=make_mesh(device="cpu"))
    assert bool(res8.solved.all())
    assert not bool(res8.overflowed.any())
    assert torch.equal(res8.solved, res1.solved)
    assert native.available(), "the native oracle did not build"
    for j in range(grids.shape[0]):
        sol = res8.solution[j].numpy()
        assert is_valid_solution(sol)
        np.testing.assert_array_equal(sol, native.solve(grids[j])[0])


def test_fused_sharded_via_dispatch():
    """``solve_batch_sharded`` with a fused config routes to the fused
    driver and agrees with the composite sharded path."""
    grids = np.stack([EASY_9, HARD_9[0]])
    ref = solve_batch_sharded(grids, SUDOKU_9, SolverConfig(min_lanes=16), device="cpu")
    got = solve_batch_sharded(grids, SUDOKU_9, _cfg(), device="cpu")
    assert torch.equal(got.solved, ref.solved)
    assert torch.equal(got.solution, ref.solution)


def test_fused_ring_steal_spreads_one_hard_job():
    grids = np.asarray(HARD_9[0])[None]
    cfg = _cfg(min_lanes=32, stack_slots=32, ring_steal_k=4, fused_steps=2)
    res = solve_batch_fused_sharded(grids, SUDOKU_9, cfg, device="cpu")
    assert bool(res.solved[0])
    assert int(res.steals) > 0, "no cross-shard (or local) steal ever happened"
    assert is_valid_solution(res.solution[0].numpy())


def test_fused_sharded_unsat_is_proven():
    res = solve_batch_fused_sharded(_unsat_board()[None], SUDOKU_9, _cfg(), device="cpu")
    assert not bool(res.solved[0])
    assert bool(res.unsat[0])
    assert not bool(res.overflowed[0])
    assert int(res.sol_count[0]) == 0


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_fused_submesh_sizes(n_dev):
    grids = np.stack([EASY_9, HARD_9[0]])
    res = solve_batch_fused_sharded(grids, SUDOKU_9, _cfg(), mesh=_mesh(n_dev))
    assert bool(res.solved.all())
    assert bool((res.sol_count == 1).all())
    for j in range(2):
        assert is_valid_solution(res.solution[j].numpy())


def test_bulk_mesh_accepts_fused():
    """``solve_bulk`` with a mesh and an explicit fused first pass runs the
    sharded fused driver end to end (on the CPU, K2's plain version)."""
    boards = np.stack([EASY_9, HARD_9[0], _unsat_board(), HARD_9[2]]).astype(np.int32)
    mesh = make_mesh(device="cpu")
    ref = solve_bulk(boards, SUDOKU_9, BulkConfig(chunk=8, stack_slots=16, step_impl="xla"),
                     mesh=mesh)
    got = solve_bulk(boards, SUDOKU_9, BulkConfig(chunk=8, stack_slots=16, step_impl="fused"),
                     mesh=mesh)
    assert (got.solved == ref.solved).all()
    assert (got.unsat == ref.unsat).all()
    assert (got.solution == ref.solution).all()


def test_fused_sharded_rejects_generic_csp():
    from distributed_sudoku_solver_tpu_torch.models.cover import build_cover

    problem = build_cover("eye4", np.eye(4, dtype=bool), n_primary=4)
    with pytest.raises(ValueError, match="Sudoku"):
        solve_csp_sharded(problem.initial_state()[None], problem, _cfg(), device="cpu")


# -- tests/test_fused_step.py and tests/test_cover_fused.py mesh cases -------------


def test_count_all_fused_sharded_psum_exact():
    empty = np.zeros((1, 4, 4), np.int32)
    cfg = _cfg(count_all=True, min_lanes=16, max_steps=100_000)
    res = solve_batch_fused_sharded(empty, SUDOKU_4, cfg, device="cpu")
    assert int(res.sol_count[0]) == 288
    assert bool(res.unsat[0])
    assert not bool(res.overflowed[0])


def test_fused_cover_sharded_on_mesh():
    """K3's plain version on eight shards: find-one solves with a valid
    decode, and ``count_all`` sums disjoint per-shard counts (6-queens: 4)."""
    p = nqueens_cover(6)
    roots = p.initial_state()[None]
    cfg = SolverConfig(step_impl="fused", min_lanes=8 * 16, stack_slots=64, max_steps=20_000)
    res = solve_csp_fused_sharded(roots, p, cfg, device="cpu")
    assert bool(res.solved[0])
    assert is_valid_queens(decode_queens(p, res.solution[0].numpy(), 6), 6)
    cnt = dataclasses.replace(cfg, count_all=True)
    rf = solve_csp_fused_sharded(roots, p, cnt, device="cpu")
    rx = solve_csp_sharded(roots, p, dataclasses.replace(cnt, step_impl="xla"), device="cpu")
    assert int(rf.sol_count[0]) == int(rx.sol_count[0]) == 4
    assert bool(rf.unsat[0]) and not bool(rf.overflowed[0])


# -- parity with the JAX package --------------------------------------------------

SIZES = [1, 2, 4, 8]


def _assert_fused_equal(got, want):
    for name in want._fields:
        if name == "sweeps":  # the port's per-lane sum (module docstring)
            continue
        w = np.asarray(getattr(want, name))
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)


@pytest.mark.parametrize("n_dev", SIZES)
def test_solve_batch_fused_sharded_matches_jax(n_dev):
    carved = [make_puzzle(SUDOKU_9, 500 + n_dev + i, n_clues=24, unique=False) for i in range(4)]
    grids = np.stack([*carved, HARD_9[0], HARD_9[1]]).astype(np.int32)
    kw = dict(min_lanes=16, stack_slots=16, max_steps=4096, step_impl="fused", ring_steal_k=4)
    want = jfs.solve_batch_fused_sharded(grids, J9, JSolverConfig(**kw),
                                         mesh=jax_make_mesh(jax.devices()[:n_dev]))
    cuda_step.fused_rounds_cuda.launches = 0
    got = solve_batch_fused_sharded(grids, SUDOKU_9, SolverConfig(**kw), mesh=_mesh(n_dev))
    assert cuda_step.fused_rounds_cuda.launches == 0  # CPU shards: the plain version
    _assert_fused_equal(got, want)


@pytest.mark.parametrize("n_dev", SIZES)
def test_solve_csp_fused_sharded_matches_jax(n_dev):
    jp, p = jax_nqueens(6), nqueens_cover(6)
    roots = np.asarray(jp.initial_state())[None]
    for count_all in (False, True):
        kw = dict(min_lanes=8 * 16, stack_slots=64, max_steps=20_000, step_impl="fused",
                  count_all=count_all)
        want = jfs.solve_csp_fused_sharded(roots, jp, JSolverConfig(**kw),
                                           mesh=jax_make_mesh(jax.devices()[:n_dev]))
        cuda_cover.cover_fused_rounds_cuda.launches = 0
        got = solve_csp_fused_sharded(roots, p, SolverConfig(**kw), mesh=_mesh(n_dev))
        assert cuda_cover.cover_fused_rounds_cuda.launches == 0
        _assert_fused_equal(got, want)
