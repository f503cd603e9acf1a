"""Port parity: composite solve, frontier state, bulk pipeline and wire bytes against JAX.

Inputs come from numpy seeds.  Tolerance: exact equality — the composite
step (``step_impl='xla'``) is bit-exact on every result field, the wire
formats are byte-identical, and a frontier converted from JAX's numpy form
steps to the same state in both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops import wire as jwire
from distributed_sudoku_solver_tpu.ops.bulk import BulkConfig as JBulkConfig
from distributed_sudoku_solver_tpu.ops.bulk import solve_bulk as jax_solve_bulk
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.frontier import frontier_step as jax_frontier_step
from distributed_sudoku_solver_tpu.ops.pallas_step import frontier_to_fused as jax_to_fused
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.ops.solve import sudoku_csp as jax_sudoku_csp
from distributed_sudoku_solver_tpu.utils.checkpoint import advance_frontier as jax_advance
from distributed_sudoku_solver_tpu.utils.checkpoint import start_frontier as jax_start
from distributed_sudoku_solver_tpu.utils.puzzles import HARD_9, make_puzzle
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import wire
from distributed_sudoku_solver_tpu_torch.ops.bulk import BulkConfig, solve_bulk
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    frontier_from_numpy,
    frontier_step,
    frontier_to_numpy,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch, solve_one, sudoku_csp
from distributed_sudoku_solver_tpu_torch.utils.oracle import solve_oracle

FIELDS = ("solution", "solved", "unsat", "overflowed", "nodes", "sol_count", "steps",
          "sweeps", "expansions", "steals")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain torch paths here are many small ops: under parallel test
    workers on a small host, torch's default thread pool per process
    oversubscribes the cores and slows them by orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grids(bh, bw, count, seed, frac=0.3):
    jg = JGeometry(bh, bw)
    n = jg.n
    return np.stack([
        make_puzzle(jg, seed + i, n_clues=int(n * n * frac), unique=False) for i in range(count)
    ]).astype(np.int32)


def _assert_same(got, want, skip=()):
    for f in FIELDS:
        if f in skip:
            continue
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("bh,bw,kw", [
    (2, 2, dict(min_lanes=16)),
    (2, 3, dict(min_lanes=16, branch="mixed", rules="subsets")),
    (3, 3, dict(min_lanes=32)),
    (3, 3, dict(min_lanes=32, branch="minrem-desc", stack_slots=3, rules="extended")),
    (3, 3, dict(min_lanes=32, branch_k=3, steal_rounds=2, propagator="pallas")),
])
def test_composite_solve_bit_exact_vs_jax(bh, bw, kw):
    grids = _grids(bh, bw, 10, seed=bh * 10 + bw)
    if bh * bw == 9:
        grids = np.concatenate([grids, np.stack(HARD_9[:2]).astype(np.int32)])
    jcfg = JSolverConfig(max_steps=3000, **kw)
    want = jax_solve_batch(jnp.asarray(grids), JGeometry(bh, bw), jcfg)
    got = solve_batch(grids, Geometry(bh, bw), SolverConfig.from_fields(jcfg), device="cpu")
    _assert_same(got, want)


# Wider boards than the rows above: 16x16 with minrem, then with the
# extended rules and a mixed branch rule, and 12x12 (3x4 boxes) with subsets.
@pytest.mark.parametrize("bh,bw,kw", [
    (4, 4, dict(min_lanes=16)),
    (4, 4, dict(min_lanes=16, rules="extended", branch="mixed")),
    (3, 4, dict(min_lanes=16, rules="subsets")),
], ids=["16x16-minrem", "16x16-extended-mixed", "12x12-subsets"])
def test_wide_composite_solve_bit_exact_vs_jax(bh, bw, kw):
    grids = _grids(bh, bw, 6, seed=bh * 10 + bw, frac=0.45)
    jcfg = JSolverConfig(max_steps=3000, stack_slots=24, **kw)
    want = jax_solve_batch(jnp.asarray(grids), JGeometry(bh, bw), jcfg)
    got = solve_batch(grids, Geometry(bh, bw), SolverConfig.from_fields(jcfg), device="cpu")
    _assert_same(got, want)
    assert bool(got.solved.any()) and int(got.nodes.sum()) > 0 and int(got.steals) > 0


def test_count_all_and_unsat_bit_exact_vs_jax():
    grids = _grids(2, 2, 6, seed=3, frac=0.2)
    grids[0] = 0  # empty 4x4 board: 288 solutions
    grids[1, 0, :2] = 1  # two 1s in a row: unsat
    jcfg = JSolverConfig(min_lanes=16, count_all=True, max_steps=5000)
    want = jax_solve_batch(jnp.asarray(grids), JGeometry(2, 2), jcfg)
    got = solve_batch(grids, Geometry(2, 2), SolverConfig.from_fields(jcfg), device="cpu")
    _assert_same(got, want)
    assert int(got.sol_count[0]) == 288 and bool(got.unsat[1])


def test_branch_first_matches_the_copied_oracle():
    grids = np.stack([HARD_9[0]] + list(_grids(3, 3, 3, seed=17, frac=0.35)))
    res = solve_batch(grids, Geometry(3, 3), SolverConfig(branch="first", min_lanes=1, steal=False,
                                                          stack_slots=81), device="cpu")
    for i, g in enumerate(grids):
        assert bool(res.solved[i])
        assert np.array_equal(res.solution[i].numpy(), solve_oracle(g))
    sol, res1 = solve_one(HARD_9[1], Geometry(3, 3), device="cpu")
    assert np.array_equal(sol, solve_oracle(HARD_9[1])) and bool(res1.solved[0])


def test_frontier_round_trip_then_one_step_in_each_package():
    grids = _grids(3, 3, 8, seed=23)
    jg, tg = JGeometry(3, 3), Geometry(3, 3)
    jcfg = JSolverConfig(min_lanes=16, stack_slots=5, rules="extended", steal_rounds=2)
    tcfg = SolverConfig.from_fields(jcfg)
    state = jax_advance(jax_start(jnp.asarray(grids), jg, jcfg), jnp.int32(3), jg, jcfg)
    host = {k: np.asarray(v) for k, v in state._asdict().items()}
    port = frontier_from_numpy(host)
    back = frontier_to_numpy(port)
    assert all(np.array_equal(back[k], host[k]) and back[k].dtype == host[k].dtype for k in host)
    want = jax_frontier_step(state, jax_sudoku_csp(jg, jcfg), jcfg)
    got = frontier_to_numpy(frontier_step(port, sudoku_csp(tg, tcfg), tcfg))
    for k, v in want._asdict().items():
        assert np.array_equal(got[k], np.asarray(v)), k
    # The fused form, boards-last in JAX, reads as the same lane-first frontier.
    fused = {k: np.asarray(v) for k, v in jax_to_fused(want)._asdict().items()}
    port_fused = frontier_from_numpy(fused)
    assert np.array_equal(port_fused.top.numpy().view(np.uint32), np.asarray(want.top))
    back_fused = frontier_to_numpy(port_fused)
    for k, v in want._asdict().items():
        assert np.array_equal(back_fused[k], np.asarray(v)) and back_fused[k].dtype == v.dtype, k


def test_solve_bulk_matches_jax():
    grids = np.concatenate([_grids(3, 3, 253, seed=100, frac=0.28),
                            np.stack(HARD_9).astype(np.int32)])
    grids[5, 0, :2] = 1  # an unsat board
    want = jax_solve_bulk(grids, JGeometry(3, 3), JBulkConfig(chunk=128))
    trace: dict = {}
    got = solve_bulk(grids, Geometry(3, 3), BulkConfig(chunk=128), trace=trace, device="cpu")
    for f in ("solution", "solved", "unsat", "by_propagation"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.searched == want.searched
    assert trace["chunks"] == 2 and trace["step_impl"] == "xla"


@pytest.mark.parametrize("bh,bw", [(2, 2), (3, 3), (4, 4)])
def test_wire_bytes_identical(bh, bw):
    jg, tg = JGeometry(bh, bw), Geometry(bh, bw)
    n = jg.n
    rng = np.random.default_rng(bh * 7 + bw)
    grids = rng.integers(0, n + 1, size=(9, n, n)).astype(np.int32)
    grids[0, 0, 0] = n + 3  # corrupt cell
    verdicts = [rng.random(9) < 0.5 for _ in range(3)]
    fmts = ["packed"] + (["dense"] if wire.uses_dense(tg) else [])
    assert wire.best_format(tg) == jwire.best_format(jg)
    for fmt in fmts:
        packed = wire.pack_grids_for(grids, tg, fmt)
        assert np.array_equal(packed, jwire.pack_grids_for(grids, jg, fmt))
        if fmt == "dense":
            dev_t = wire.unpack_grids_dense_device(torch.from_numpy(packed), tg)
            dev_j = jwire.unpack_grids_dense_device(jnp.asarray(packed), jg)
            res_t = wire.pack_result_dense_device(torch.from_numpy(grids), *map(torch.from_numpy, verdicts), tg)
            res_j = jwire.pack_result_dense_device(jnp.asarray(grids), *map(jnp.asarray, verdicts), jg)
        else:
            dev_t = wire.unpack_grids_device(torch.from_numpy(packed), tg)
            dev_j = jwire.unpack_grids_device(jnp.asarray(packed), jg)
            res_t = wire.pack_result_device(torch.from_numpy(grids), *map(torch.from_numpy, verdicts), tg)
            res_j = jwire.pack_result_device(jnp.asarray(grids), *map(jnp.asarray, verdicts), jg)
        assert np.array_equal(dev_t.numpy(), np.asarray(dev_j))
        assert np.array_equal(res_t.numpy(), np.asarray(res_j))
        for a, b in zip(wire.unpack_result_for(res_t.numpy(), tg, fmt),
                        jwire.unpack_result_for(np.asarray(res_j), jg, fmt)):
            assert np.array_equal(a, b)
