"""The lane-sharded composite solve (``parallel/sharded.py``) against the
JAX package's, and the mesh cases of its bulk and cover tests.

JAX runs on its eight CPU devices (conftest); the port on meshes of 1, 2,
4 and 8 CPU shards (``virtual_devices(8)``, entered for every test here).
The cases of ``tests/test_sharded.py`` come first, then parity with JAX's
``solve_batch_sharded``, ``solve_csp_sharded`` and
``solve_batch_sharded_wire`` on the same boards (made from seeds with
numpy): bit-exact on every field of the result, ``steals`` and ``steps``
included.  Then the bulk mesh cases of ``tests/test_bulk.py`` and the
cover mesh cases of ``tests/test_cover.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import SUDOKU_9 as J9
from distributed_sudoku_solver_tpu.models.nqueens import nqueens_cover as jax_nqueens
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops import wire as jwire
from distributed_sudoku_solver_tpu.parallel import make_mesh as jax_make_mesh
from distributed_sudoku_solver_tpu.parallel import sharded as jsharded
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9
from distributed_sudoku_solver_tpu_torch.models.nqueens import decode_queens, is_valid_queens
from distributed_sudoku_solver_tpu_torch.models.nqueens import nqueens_cover
from distributed_sudoku_solver_tpu_torch.ops import wire
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
from distributed_sudoku_solver_tpu_torch.parallel import (
    make_mesh,
    solve_batch_sharded,
    solve_batch_sharded_wire,
    solve_csp_sharded,
    virtual_devices,
)
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution, solve_oracle
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


def _mesh(n_dev: int):
    return make_mesh([CPU] * n_dev)


def _respects_clues(solution, puzzle):
    return bool(np.all((np.asarray(puzzle) == 0) | (np.asarray(solution) == puzzle)))


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_bit_exact(got, want):
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(getattr(want, name)),
                                      err_msg=name)


# -- the cases of tests/test_sharded.py -----------------------------------------


def test_mesh_has_8_devices():
    assert make_mesh(device="cpu").size == 8


def test_sharded_matches_single_device():
    grids = np.stack([EASY_9, *HARD_9])
    cfg = SolverConfig(min_lanes=64, stack_slots=64)
    res1 = solve_batch(grids, SUDOKU_9, cfg, device="cpu")
    res8 = solve_batch_sharded(grids, SUDOKU_9, cfg, mesh=make_mesh(device="cpu"))
    assert bool(res8.solved.all())
    assert not bool(res8.overflowed.any())
    assert torch.equal(res8.solved, res1.solved)
    for j in range(grids.shape[0]):
        sol = res8.solution[j].numpy()
        assert is_valid_solution(sol)
        assert _respects_clues(sol, grids[j])
    assert torch.equal(res8.solution, res1.solution)


def test_sharded_bit_exact_vs_oracle():
    # The native oracle (held equal to the pure-Python one by
    # test_torch_native_parity.py), which takes milliseconds on HARD_9[2].
    from distributed_sudoku_solver_tpu_torch import native

    assert native.available(), "the native oracle did not build"
    grids = np.stack(HARD_9)
    res = solve_batch_sharded(grids, SUDOKU_9, SolverConfig(), device="cpu")
    for j in range(grids.shape[0]):
        np.testing.assert_array_equal(res.solution[j].numpy(), native.solve(grids[j])[0])


def test_ring_steal_spreads_one_hard_job():
    # One job on eight shards: only the ring steal can occupy seven of them.
    grids = np.asarray(HARD_9[0])[None]
    cfg = SolverConfig(min_lanes=32, stack_slots=64, ring_steal_k=4)
    res = solve_batch_sharded(grids, SUDOKU_9, cfg, device="cpu")
    assert bool(res.solved[0])
    assert int(res.steals) > 0
    assert is_valid_solution(res.solution[0].numpy())


def test_sharded_unsat_is_proven():
    bad = np.asarray(EASY_9).copy()
    bad[0, 0] = 5
    bad[0, 1] = 5
    res = solve_batch_sharded(bad[None], SUDOKU_9, SolverConfig(), device="cpu")
    assert not bool(res.solved[0])
    assert bool(res.unsat[0])
    assert not bool(res.overflowed[0])


def test_single_device_submesh():
    res = solve_batch_sharded(np.stack([EASY_9]), SUDOKU_9, SolverConfig(), mesh=_mesh(1))
    assert bool(res.solved[0])
    assert is_valid_solution(res.solution[0].numpy())


@pytest.mark.parametrize("n_dev", [2, 4])
def test_submesh_sizes(n_dev):
    grids = np.stack([EASY_9, HARD_9[0]])
    res = solve_batch_sharded(grids, SUDOKU_9, SolverConfig(), mesh=_mesh(n_dev))
    assert bool(res.solved.all())
    for j in range(2):
        assert is_valid_solution(res.solution[j].numpy())


# -- parity with the JAX package, every field -------------------------------------

SIZES = [1, 2, 4, 8]


def _boards(seed: int, count: int = 5) -> np.ndarray:
    carved = [make_puzzle(SUDOKU_9, seed + i, n_clues=24, unique=False) for i in range(count)]
    return np.stack([*carved, HARD_9[0], HARD_9[1]]).astype(np.int32)


@pytest.mark.parametrize("n_dev", SIZES)
def test_solve_batch_sharded_bit_exact_vs_jax(n_dev):
    grids = _boards(100 + n_dev)
    kw = dict(min_lanes=16, stack_slots=16, ring_steal_k=4)
    want = jsharded.solve_batch_sharded(grids, J9, JSolverConfig(**kw),
                                        mesh=jax_make_mesh(jax.devices()[:n_dev]))
    got = solve_batch_sharded(grids, SUDOKU_9, SolverConfig(**kw), mesh=_mesh(n_dev))
    _assert_bit_exact(got, want)


@pytest.mark.parametrize("n_dev", SIZES)
def test_solve_csp_sharded_count_all_bit_exact_vs_jax(n_dev):
    """Enumeration on the cover family: per-shard counts sum exactly."""
    jp, p = jax_nqueens(7), nqueens_cover(7)
    roots = np.asarray(jp.initial_state())[None]
    kw = dict(min_lanes=16, stack_slots=64, max_steps=20_000, count_all=True)
    want = jsharded.solve_csp_sharded(roots, jp, JSolverConfig(**kw),
                                      mesh=jax_make_mesh(jax.devices()[:n_dev]))
    got = solve_csp_sharded(roots, p, SolverConfig(**kw), mesh=_mesh(n_dev))
    _assert_bit_exact(got, want)
    assert int(got.sol_count[0]) == 40


@pytest.mark.parametrize("n_dev", SIZES)
def test_solve_batch_sharded_wire_bit_exact_vs_jax(n_dev):
    grids = _boards(200 + n_dev)
    kw = dict(min_lanes=16, stack_slots=16)
    packed = wire.pack_grids_host(grids, SUDOKU_9)
    np.testing.assert_array_equal(packed, jwire.pack_grids_host(grids, J9))
    want = jsharded.solve_batch_sharded_wire(jnp.asarray(packed), J9, JSolverConfig(**kw),
                                             jax_make_mesh(jax.devices()[:n_dev]))
    got = solve_batch_sharded_wire(torch.from_numpy(packed), SUDOKU_9, SolverConfig(**kw),
                                   _mesh(n_dev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_config_rejected_on_generic_csp():
    p = nqueens_cover(4)
    with pytest.raises(ValueError, match="Sudoku"):
        solve_csp_sharded(p.initial_state()[None], p, SolverConfig(step_impl="fused"),
                          device="cpu")


def test_kernel_error_is_not_swallowed(monkeypatch):
    """A kernel failing inside the mesh program surfaces as itself."""
    from distributed_sudoku_solver_tpu_torch.ops import cuda_build, cuda_propagate

    def failing(*args, **kwargs):
        raise cuda_build.KernelError("propagate.cu : nvcc failed (1)")

    monkeypatch.setattr(cuda_propagate, "propagate_fixpoint_pallas", failing)
    with pytest.raises(cuda_build.KernelError):
        solve_batch_sharded(np.stack([HARD_9[0]]), SUDOKU_9,
                            SolverConfig(propagator="pallas"), device="cpu")


# -- the bulk mesh cases of tests/test_bulk.py -------------------------------------


def _corpus(n_gen: int) -> np.ndarray:
    carved = [make_puzzle(SUDOKU_9, 300 + i, n_clues=26, unique=False) for i in range(n_gen)]
    return np.stack([*carved, *HARD_9]).astype(np.int32)


def test_bulk_sharded_matches_single_device():
    grids = _corpus(n_gen=8)
    a = solve_bulk(grids, SUDOKU_9, BulkConfig(chunk=8), device="cpu")
    s = solve_bulk(grids, SUDOKU_9, BulkConfig(chunk=8), mesh=make_mesh(device="cpu"))
    np.testing.assert_array_equal(a.solved, s.solved)
    assert s.solved.all()
    for g, sol in zip(grids, s.solution):
        assert is_valid_solution(sol)
        assert ((g == 0) | (sol == g)).all()


def test_bulk_sharded_ragged_chunk_pads_evenly():
    grids = _corpus(n_gen=2)[:5]  # 5 boards over 8 shards: the pad path
    res = solve_bulk(grids, SUDOKU_9, BulkConfig(chunk=16), mesh=make_mesh(device="cpu"))
    assert res.solved.all() and len(res.solved) == 5


def test_bulk_mesh_rungs_resolve_stragglers():
    """A first pass too short to finish sends the boards through the rungs,
    one sharded solve each, as in the JAX package."""
    grids = np.stack(HARD_9[:2]).astype(np.int32)
    trace: dict = {}
    res = solve_bulk(grids, SUDOKU_9, BulkConfig(chunk=8, first_pass_steps=2),
                     mesh=make_mesh(device="cpu"), trace=trace)
    assert trace["remaining_after_first"] >= 1
    assert trace["rungs"][0]["dispatches"] >= 1
    assert trace["rungs"][0]["lanes"] % 8 == 0
    assert res.solved.all()
    for g, sol in zip(grids, res.solution):
        np.testing.assert_array_equal(sol, solve_oracle(g))


# -- the cover mesh cases of tests/test_cover.py -----------------------------------


def test_cover_sharded_on_mesh():
    p = nqueens_cover(10)
    cfg = SolverConfig(min_lanes=16, stack_slots=64, max_steps=20_000, ring_steal_k=4)
    res = solve_csp_sharded(p.initial_state()[None], p, cfg, mesh=make_mesh(device="cpu"))
    assert bool(res.solved[0])
    assert is_valid_queens(decode_queens(p, res.solution[0].numpy(), 10), 10)


def test_count_all_sharded_exact():
    p = nqueens_cover(8)
    cfg = SolverConfig(min_lanes=64, stack_slots=128, max_steps=100_000, count_all=True)
    res = solve_csp_sharded(p.initial_state()[None], p, cfg, mesh=make_mesh(device="cpu"))
    assert int(res.sol_count[0]) == 92
    assert bool(res.unsat[0])
    assert not bool(res.overflowed[0])
