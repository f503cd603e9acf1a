"""Port parity: the exact-cover family (models and the composite solve) against JAX.

Instances are built by both packages from the same definitions; root states
and clue grids come from numpy.  Tolerance: exact equality.  The composite
step (``step_impl='xla'``) is bit-exact on every result field, including
the batch-global sweep count.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_sudoku_solver_tpu.models import cover as jcover
from distributed_sudoku_solver_tpu.models import nqueens as jnq
from distributed_sudoku_solver_tpu.models import pentomino as jpent
from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.frontier import frontier_step as jax_frontier_step
from distributed_sudoku_solver_tpu.ops.frontier import init_frontier as jax_init_frontier
from distributed_sudoku_solver_tpu.ops.solve import solve_csp as jax_solve_csp
from distributed_sudoku_solver_tpu.utils.puzzles import make_puzzle
from distributed_sudoku_solver_tpu_torch.models import cover, nqueens, pentomino
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    frontier_from_numpy,
    frontier_step,
    frontier_to_numpy,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_csp
from distributed_sudoku_solver_tpu_torch.utils.oracle import is_valid_solution

FIELDS = ("solution", "solved", "unsat", "overflowed", "nodes", "sol_count", "steps",
          "sweeps", "expansions", "steals")

INSTANCES = {
    "nqueens4": (lambda: jnq.nqueens_cover(4), lambda: nqueens.nqueens_cover(4)),
    "nqueens8": (lambda: jnq.nqueens_cover(8), lambda: nqueens.nqueens_cover(8)),
    "pentomino3x20": (lambda: jpent.pentomino_cover(3, 20),
                      lambda: pentomino.pentomino_cover(3, 20)),
    "sudoku-cover4x4": (lambda: jcover.sudoku_cover(JGeometry(2, 2)),
                        lambda: cover.sudoku_cover(Geometry(2, 2))),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain torch paths here are many small ops: under parallel test
    workers on a small host, torch's default thread pool per process
    oversubscribes the cores and slows them by orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _as_i32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_same(got, want, skip=()):
    for f in FIELDS:
        if f in skip:
            continue
        assert np.array_equal(getattr(got, f).numpy(), _as_i32(getattr(want, f))), f


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_instances_and_carry_across_match_jax(name):
    make_j, make_t = INSTANCES[name]
    jp, tp = make_j(), make_t()
    assert tp.signature() == jp.signature()
    for f in ("col_rows", "row_cols", "elim", "incidence"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b), f
    assert (tp.n_rows, tp.n_primary, tp.n_cols_full, tp.state_shape) == (
        jp.n_rows, jp.n_primary, jp.n_cols_full, jp.state_shape)
    assert np.array_equal(tp.initial_state().view(np.uint32), jp.initial_state())
    carried = cover.cover_from_numpy(jp)
    assert carried == tp and carried.signature() == jp.signature()
    fields = {f: getattr(jp, f) for f in cover._FIELDS}
    assert cover.cover_from_numpy(fields).signature() == jp.signature()
    # A root with rows taken: the first available row, then the next compatible one.
    rows = [0]
    avail = ~jcover._unpack_bits(jp.elim, jp.n_rows)[0]
    avail[0] = False
    rows += [int(np.nonzero(avail)[0][0])] if avail.any() else []
    assert np.array_equal(tp.state_with_rows_taken(rows).view(np.uint32),
                          jp.state_with_rows_taken(rows))


def test_branch_status_and_propagate_match_jax_on_a_seeded_batch():
    """The three CSProblem functions on states with seeded rows taken, on an
    instance with W_r > 32 words (rows 31, 63, ... sit on the sign bit)."""
    jp, tp = jpent.pentomino_cover(3, 20), pentomino.pentomino_cover(3, 20)
    assert tp.w_rows > 32
    rng = np.random.default_rng(4)
    elim = jcover._unpack_bits(jp.elim, jp.n_rows)
    states = []
    for _ in range(48):
        avail = np.ones(jp.n_rows, bool)
        rows = []
        for _ in range(rng.integers(0, 4)):
            if not avail.any():
                break
            r = int(rng.choice(np.nonzero(avail)[0]))
            rows.append(r)
            avail &= ~elim[r]
            avail[r] = False
        states.append(jp.state_with_rows_taken(rows))
    js = np.stack(states)
    ts = torch.from_numpy(js.view(np.int32))
    for name in ("status", "branch", "propagate"):
        got = getattr(tp, name)(ts)
        want = getattr(jp, name)(jnp.asarray(js))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), _as_i32(w)), name
    fix, per_lane = tp.propagate_per_lane(ts)
    batch, sweeps = tp.propagate(ts)
    assert torch.equal(fix, batch) and int(per_lane.max()) == int(sweeps)
    for i in range(0, 48, 7):  # each lane's own count is what it needs alone
        assert int(per_lane[i]) == int(tp.propagate(ts[i : i + 1])[1])


def _sudoku_roots():
    jg = JGeometry(2, 2)
    grids = [make_puzzle(jg, 70 + i, n_clues=5, unique=False) for i in range(6)]
    jp = jcover.sudoku_cover(jg)
    roots = np.stack([jp.state_with_rows_taken(jcover.sudoku_clue_rows(g)) for g in grids])
    return grids, roots


@pytest.mark.parametrize("case", [
    ("nqueens", 2, dict()),
    ("nqueens", 3, dict()),
    ("nqueens", 6, dict()),
    ("nqueens", 8, dict(steal_rounds=2)),
    ("nqueens", 6, dict(count_all=True)),
    ("nqueens", 8, dict(count_all=True, stack_slots=4)),
    ("sudoku", 4, dict()),
    ("sudoku", 4, dict(count_all=True)),
], ids=lambda c: "-".join([f"{c[0]}{c[1]}", *(f"{k}={v}" for k, v in c[2].items())]))
def test_composite_cover_solve_bit_exact_vs_jax(case):
    family, n, kw = case[0], case[1], dict(case[2])
    if family == "nqueens":
        jp, tp = jnq.nqueens_cover(n), nqueens.nqueens_cover(n)
        roots = np.repeat(jp.initial_state()[None], 3, axis=0)
    else:
        jp, tp = jcover.sudoku_cover(JGeometry(2, 2)), cover.sudoku_cover(Geometry(2, 2))
        grids, roots = _sudoku_roots()
    jcfg = JSolverConfig(min_lanes=32, stack_slots=kw.pop("stack_slots", 32), max_steps=5000, **kw)
    want = jax_solve_csp(jnp.asarray(roots), jp, jcfg)
    got = solve_csp(roots, tp, SolverConfig.from_fields(jcfg), device="cpu")
    _assert_same(got, want)
    has_sol = (got.solved | (got.sol_count > 0)).numpy()
    for j in np.nonzero(has_sol)[0]:
        sol = got.solution[j]
        if family == "nqueens":
            assert nqueens.is_valid_queens(nqueens.decode_queens(tp, sol, n), n)
        else:
            grid = cover.decode_sudoku_cover(tp, sol, 4)
            assert is_valid_solution(grid)
            assert np.array_equal(grid[grids[j] > 0], grids[j][grids[j] > 0])
    if family == "nqueens" and n in (2, 3):
        assert bool(got.unsat.all())
    if kw.get("count_all") and family == "nqueens":
        assert int(got.sol_count[0]) == {6: 4, 8: 92}[n]


def test_cover_frontier_round_trip_then_one_step_in_each_package():
    jp, tp = jnq.nqueens_cover(7), nqueens.nqueens_cover(7)
    jcfg = JSolverConfig(min_lanes=16, stack_slots=5, steal_rounds=2)
    tcfg = SolverConfig.from_fields(jcfg)
    state = jax_init_frontier(jnp.asarray(np.repeat(jp.initial_state()[None], 2, axis=0)), jcfg)
    for _ in range(4):
        state = jax_frontier_step(state, jp, jcfg)
    host = {k: np.asarray(v) for k, v in state._asdict().items()}
    port = frontier_from_numpy(host)
    back = frontier_to_numpy(port)
    assert all(np.array_equal(back[k], host[k]) for k in host)
    want = jax_frontier_step(state, jp, jcfg)
    got = frontier_to_numpy(frontier_step(port, tp, tcfg))
    for k, v in want._asdict().items():
        assert np.array_equal(got[k], np.asarray(v)), k


def test_pentomino_decode_and_validity_match_jax():
    jp, tp = jpent.pentomino_cover(3, 20), pentomino.pentomino_cover(3, 20)
    assert pentomino.placements(3, 20) == jpent.placements(3, 20)
    assert pentomino.orientations(pentomino.PENTOMINOES["F"]) == jpent.orientations(
        jpent.PENTOMINOES["F"])
    cfg = JSolverConfig(min_lanes=64, stack_slots=64, max_steps=20_000)
    want = jax_solve_csp(jnp.asarray(jp.initial_state()[None]), jp, cfg)
    got = solve_csp(tp.initial_state()[None], tp, SolverConfig.from_fields(cfg), device="cpu")
    _assert_same(got, want)
    grid = pentomino.decode_tiling(tp, got.solution[0], 3, 20)
    assert np.array_equal(grid, jpent.decode_tiling(jp, np.asarray(want.solution[0]), 3, 20))
    assert pentomino.is_valid_tiling(grid)
    bad = grid.copy()
    bad[0, 0] = bad[0, 1] if bad[0, 0] != bad[0, 1] else (bad[0, 0] + 1) % 12
    assert not pentomino.is_valid_tiling(bad)
    assert not nqueens.is_valid_queens([(0, 0), (1, 1)], 2)
