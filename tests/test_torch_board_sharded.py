"""Board-sharded (band-parallel) solve: ``parallel/board_sharded.py``
against the single-device engine and the JAX package's banded solve.

Each board's rows are banded over the shards; column aggregates travel
around a ``ppermute`` ring every sweep.  The cases of
``tests/test_board_sharded.py``, each held bit-exact (every field of the
result) against the port's single-device ``solve_batch`` and, on the same
boards, against JAX's ``solve_batch_banded`` on the same number of CPU
devices.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.parallel import board_sharded as jbs
from distributed_sudoku_solver_tpu_torch.models.geometry import (
    SUDOKU_9,
    SUDOKU_16,
    SUDOKU_25,
    Geometry,
)
from distributed_sudoku_solver_tpu_torch.ops.bitmask import once_twice_reduce, or_reduce
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch
from distributed_sudoku_solver_tpu_torch.parallel.board_sharded import (
    make_band_mesh,
    ring_once_twice,
    ring_or,
    solve_batch_banded,
    validate_banded_config,
)
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution
from distributed_sudoku_solver_tpu_torch.utils.puzzles import HARD_9, make_puzzle

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _band_mesh(n: int):
    return make_band_mesh([CPU] * n)


def _jax_banded(grids, geom, cfg, n):
    jgeom = JGeometry(geom.box_h, geom.box_w)
    mesh = jbs.make_band_mesh(jax.devices()[:n])
    return jbs.solve_batch_banded(grids, jgeom, JSolverConfig(**dataclasses.asdict(cfg)),
                                  mesh=mesh)


def _assert_matches_single_device(grids, geom, cfg, mesh, jax_too: bool = True):
    ref = solve_batch(grids, geom, cfg, device="cpu")
    res = solve_batch_banded(grids, geom, cfg, mesh=mesh)
    for name in ref._fields:
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    if jax_too:
        want = _jax_banded(grids, geom, cfg, mesh.size)
        for name in want._fields:
            w = np.asarray(getattr(want, name))
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            np.testing.assert_array_equal(getattr(res, name).numpy(), w, err_msg=name)
    return res


def test_ring_reduces_match_global():
    """ring_or / ring_once_twice == the one-device reduction of the whole array."""
    n_dev = 4
    mesh = _band_mesh(n_dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 2**25, size=(n_dev * 3, 16)).astype(np.int32))
    blocks = list(x.reshape(n_dev, 3, 16))
    parts = [once_twice_reduce(b, 0) for b in blocks]
    got_or = ring_or([or_reduce(b, 0) for b in blocks], mesh)
    got_o, got_t = ring_once_twice([p[0] for p in parts], [p[1] for p in parts], mesh)
    want_o, want_t = once_twice_reduce(x, 0)
    for i in range(n_dev):
        assert torch.equal(got_or[i], or_reduce(x, 0))
        assert torch.equal(got_o[i], want_o)
        assert torch.equal(got_t[i], want_t)


def test_9x9_exact_band_fit_bit_exact():
    """3 shards x 1 band: hard boards (real branching) match single-device."""
    grids = np.stack(HARD_9[:2]).astype(np.int32)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096)
    res = _assert_matches_single_device(grids, SUDOKU_9, cfg, _band_mesh(3))
    assert bool(res.solved.all())
    assert int(res.nodes.sum()) > 0  # branching happened


def test_9x9_padded_bands_bit_exact():
    """8 shards over 3 bands: 5 shards hold only pad rows, still bit-exact."""
    grids = np.stack(HARD_9[:2]).astype(np.int32)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096)
    res = _assert_matches_single_device(grids, SUDOKU_9, cfg, _band_mesh(8))
    assert bool(res.solved.all())


def test_16x16_banded():
    puzzles = np.stack(
        [make_puzzle(SUDOKU_16, seed=s, n_clues=170, unique=False) for s in (0, 1)])
    cfg = SolverConfig(min_lanes=8, stack_slots=64, max_steps=20_000)
    res = solve_batch_banded(puzzles, SUDOKU_16, cfg, mesh=_band_mesh(4))
    assert bool(res.solved.all())
    for j in range(puzzles.shape[0]):
        sol = res.solution[j].numpy()
        assert is_valid_solution(sol, SUDOKU_16)
        mask = puzzles[j] != 0
        assert np.array_equal(sol[mask], puzzles[j][mask])


def test_25x25_banded_bit_exact():
    """One board's 25 rows = 5 box bands over 5 shards."""
    puzzle = make_puzzle(SUDOKU_25, seed=3, n_clues=480, unique=False)
    cfg = SolverConfig(min_lanes=4, stack_slots=48, max_steps=50_000)
    res = _assert_matches_single_device(puzzle[None], SUDOKU_25, cfg, _band_mesh(5))
    assert bool(res.solved[0])
    assert is_valid_solution(res.solution[0].numpy(), SUDOKU_25)


def test_9x9_extended_rules_bit_exact():
    """rules='extended': same solutions AND node counts, so the cross-shard
    pointing / claiming eliminations are exactly the unsharded ones."""
    grids = np.stack(HARD_9[:2]).astype(np.int32)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096, rules="extended")
    res = _assert_matches_single_device(grids, SUDOKU_9, cfg, _band_mesh(3))
    assert bool(res.solved.all())


def test_9x9_extended_rules_padded_bands_bit_exact():
    grids = np.stack(HARD_9[:2]).astype(np.int32)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096, rules="extended")
    res = _assert_matches_single_device(grids, SUDOKU_9, cfg, _band_mesh(8))
    assert bool(res.solved.all())


def test_25x25_extended_rules_banded():
    """Extended rules close the giant board with no more nodes than basic
    and stay bit-exact against one device."""
    puzzle = make_puzzle(SUDOKU_25, seed=3, n_clues=480, unique=False)
    cfg = SolverConfig(min_lanes=4, stack_slots=48, max_steps=50_000, rules="extended")
    res = _assert_matches_single_device(puzzle[None], SUDOKU_25, cfg, _band_mesh(5),
                                        jax_too=False)
    assert bool(res.solved[0])
    assert is_valid_solution(res.solution[0].numpy(), SUDOKU_25)
    basic = solve_batch_banded(puzzle[None], SUDOKU_25,
                               SolverConfig(min_lanes=4, stack_slots=48, max_steps=50_000),
                               mesh=_band_mesh(5))
    assert int(res.nodes[0]) <= int(basic.nodes[0])


def test_12x12_extended_rules_rectangular_boxes():
    """Rectangular boxes exercise the transposed box layout of the banded
    columns direction."""
    geom = Geometry(3, 4)
    puzzle = make_puzzle(geom, seed=7, n_clues=75, unique=False)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=20_000, rules="extended")
    res = _assert_matches_single_device(puzzle[None], geom, cfg, _band_mesh(4))
    assert bool(res.solved[0])
    assert is_valid_solution(res.solution[0].numpy(), geom)


def test_banded_unsat_detected():
    """A row-duplicate contradiction is proven unsat across shards."""
    puzzle = np.stack(HARD_9[:1]).astype(np.int32)[0]
    r, c = np.argwhere(puzzle == 0)[0]
    row_digits = set(puzzle[r][puzzle[r] > 0])
    puzzle = puzzle.copy()
    puzzle[r, c] = next(iter(row_digits))
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096)
    res = solve_batch_banded(puzzle[None], SUDOKU_9, cfg, mesh=_band_mesh(3))
    assert not bool(res.solved[0])
    assert bool(res.unsat[0])


# -- beyond the JAX test file ------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_subsets_banded_bit_exact(n_dev):
    """rules='subsets' (the all_gather of the columns) at every mesh size."""
    grids = np.stack(HARD_9[:2]).astype(np.int32)
    cfg = SolverConfig(min_lanes=8, stack_slots=32, max_steps=4096, rules="subsets")
    _assert_matches_single_device(grids, SUDOKU_9, cfg, _band_mesh(n_dev))


def test_banded_rejects_what_it_cannot_honour():
    for bad in (SolverConfig(propagator="pallas"), SolverConfig(branch="mixed"),
                SolverConfig(branch="head:minrem")):
        with pytest.raises(ValueError):
            validate_banded_config(bad)
        with pytest.raises(ValueError):
            solve_batch_banded(np.stack([HARD_9[0]]), SUDOKU_9, bad, mesh=_band_mesh(2))
