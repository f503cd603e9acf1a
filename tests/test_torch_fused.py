"""Port parity: the fused round (K2's plain path) and the fused solve against JAX.

JAX's ``fused_rounds`` runs as its own tests run it on the CPU (Pallas
interpret mode), on boards-last tensors that the test transposes to the
port's lane-first layout.  Tolerance: exact equality of every output except
``sweeps_total``, which depends on tiling (the port sums each lane's own
sweeps; the TPU kernel summed per-tile sweeps) and is compared against the
port's definition instead.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.pallas_step import fused_rounds as jax_fused_rounds
from distributed_sudoku_solver_tpu.ops.solve import solve_batch as jax_solve_batch
from distributed_sudoku_solver_tpu.utils.puzzles import HARD_9, make_puzzle
from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import cuda_step
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig
from distributed_sudoku_solver_tpu_torch.ops.propagate import propagate_per_board
from distributed_sudoku_solver_tpu_torch.ops.solve import solve_batch

LANES, SLOTS, TILE, K = 128, 6, 64, 4


def _round_inputs(bh, bw, seed):
    """A lane-first frontier: carved boards as tops, other carved boards in
    partly filled circular stacks, a fifth of the lanes idle."""
    jg, tg = JGeometry(bh, bw), Geometry(bh, bw)
    n = jg.n
    rng = np.random.default_rng(seed)
    grids = np.stack([
        make_puzzle(jg, seed + i, n_clues=int(n * n * 0.3), unique=False)
        for i in range(LANES * (SLOTS + 1))
    ]).astype(np.int32)
    cand = encode_grid(torch.from_numpy(grids), tg).reshape(LANES, SLOTS + 1, n, n)
    top = cand[:, 0].contiguous()
    stack = cand[:, 1:].contiguous()
    has = torch.from_numpy(rng.random(LANES) < 0.8)
    base = torch.from_numpy(rng.integers(0, SLOTS, LANES).astype(np.int32))
    count = torch.from_numpy(rng.integers(0, SLOTS + 1, LANES).astype(np.int32))
    return tg, jg, top, stack, has, base, count


def _jax_lane_first(out):
    """JAX 13-tuple (boards-last) -> numpy, lane-first."""
    top_t, stack_t, *mid, sol_t, over, nodes, sols, live, sweeps, steps = (
        np.asarray(x) for x in out)
    return [top_t.transpose(2, 0, 1).view(np.int32), stack_t.transpose(3, 0, 1, 2).view(np.int32),
            *mid, sol_t.transpose(2, 0, 1).view(np.int32), over, nodes, sols, live, sweeps, steps]


@pytest.mark.parametrize("count_mode", [False, True])
@pytest.mark.parametrize("branch", ["minrem", "first", "mixed", "minrem-desc"])
def test_plain_fused_rounds_match_jax(branch, count_mode):
    tg, jg, top, stack, has, base, count = _round_inputs(3, 3, seed=len(branch))
    kw = dict(rules="extended", branch_rule=branch, max_sweeps=64, k_steps=K,
              count_mode=count_mode)
    want = _jax_lane_first(jax_fused_rounds(
        jnp.asarray(top.numpy().view(np.uint32).transpose(1, 2, 0)),
        jnp.asarray(stack.numpy().view(np.uint32).transpose(1, 2, 3, 0)),
        jnp.asarray(has.numpy()), jnp.asarray(base.numpy()), jnp.asarray(count.numpy()),
        jg, tile=TILE, **kw))
    cuda_step.fused_rounds_cuda.launches = 0
    got = cuda_step.fused_rounds(top, stack.clone(), has, base, count, tg, tile=TILE, **kw)
    assert cuda_step.fused_rounds_cuda.launches == 0  # CPU: plain version
    names = ("top", "stack", "has_top", "base", "count", "lane_solved", "lane_sol",
             "lane_overflow", "nodes", "sols", "live_rounds", "sweeps_total", "steps_max")
    for name, g, w in zip(names, got, want):
        if name == "sweeps_total":
            continue
        assert np.array_equal(g.numpy(), w), name
    assert int(got[12]) == int(got[10].max())  # steps_max == max(live rounds)


def test_sweeps_total_is_the_sum_of_each_lanes_own_sweeps():
    tg, _, top, stack, has, base, count = _round_inputs(3, 3, seed=9)
    kw = dict(rules="extended", branch_rule="minrem", k_steps=K, sweep_unroll=2)
    lanes = 16
    batched = cuda_step.fused_rounds(top[:lanes], stack[:lanes].clone(), has[:lanes],
                                     base[:lanes], count[:lanes], tg, tile=lanes, **kw)
    alone = 0
    for i in range(lanes):
        out = cuda_step.fused_rounds(top[i : i + 1], stack[i : i + 1].clone(), has[i : i + 1],
                                     base[i : i + 1], count[i : i + 1], tg, tile=1, **kw)
        alone += int(out[11])
    assert int(batched[11]) == alone > 0


def test_round_sweeps_use_the_unroll_floor():
    tg, _, top, stack, has, base, count = _round_inputs(2, 2, seed=5)
    live_top = torch.where(has[:, None, None], top, torch.zeros_like(top))
    _, per = propagate_per_board(live_top, tg, 64, "basic", unroll=2)
    out = cuda_step.fused_rounds(top, stack.clone(), has, base, count, tg, rules="basic",
                                 k_steps=1, tile=LANES, sweep_unroll=2)
    assert int(out[11]) == int(per[has].sum())


def _grids():
    jg = JGeometry(3, 3)
    boards = [make_puzzle(jg, 40 + i, n_clues=26, unique=False) for i in range(10)]
    return np.stack(boards + list(HARD_9[:2])).astype(np.int32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(branch="first", count_all=True, max_steps=60),
    dict(branch="mixed", stack_slots=3, rules="basic"),
    dict(branch="minrem-desc", lanes=256, fused_steps=5),
])
def test_fused_solve_matches_jax_except_sweeps(kw):
    grids = _grids()
    base = dict(min_lanes=32, max_steps=3000, step_impl="fused", fused_steps=3, rules="extended")
    jcfg = JSolverConfig(**{**base, **kw})
    want = jax_solve_batch(jnp.asarray(grids), JGeometry(3, 3), jcfg)
    got = solve_batch(grids, Geometry(3, 3), SolverConfig.from_fields(jcfg), device="cpu")
    for f in want._fields:
        if f == "sweeps":
            continue
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert int(got.sweeps) > 0


def test_fused_lanes_rounding_and_admission():
    assert cuda_step.fused_lanes(100, 9, 12) == 100
    assert cuda_step.fused_lanes(200, 9, 12) == 256
    assert cuda_step.fused_lanes(32768, 25, 4096) == 32768  # no VMEM-style depth cap
    with pytest.raises(ValueError):
        cuda_step.fused_lanes(64, 9, 0)
    assert SolverConfig(branch="head:cw-slack", step_impl="fused").branch == "head:cw-slack"
    with pytest.raises(ValueError):
        SolverConfig(branch="head:typo", step_impl="fused")
