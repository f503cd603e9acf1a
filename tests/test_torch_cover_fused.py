"""Port parity: the cover round (K3's plain path) and the fused cover solve against JAX.

JAX's ``cover_fused_rounds`` runs as its own tests run it on the CPU (Pallas
interpret mode), on ``[1, D, L]`` / ``[S, 1, D, L]`` tensors that the test
transposes to the port's lane-first layout.  Inputs are seeded with numpy:
states with random compatible rows taken, partly filled circular stacks, a
fifth of the lanes idle, 128 lanes in 64-lane tiles (so idle lanes sit in
tiles that run on).  Tolerance: exact equality of every output except
``sweeps_total``, which the port defines as the sum of each lane's own
sweeps (the TPU kernel summed per-tile sweeps) and is checked against that.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_sudoku_solver_tpu.models import cover as jcover
from distributed_sudoku_solver_tpu.models import nqueens as jnq
from distributed_sudoku_solver_tpu.models import pentomino as jpent
from distributed_sudoku_solver_tpu.models.geometry import Geometry as JGeometry
from distributed_sudoku_solver_tpu.ops.frontier import SolverConfig as JSolverConfig
from distributed_sudoku_solver_tpu.ops.pallas_cover import cover_consts as jax_cover_consts
from distributed_sudoku_solver_tpu.ops.pallas_cover import cover_fused_rounds as jax_rounds
from distributed_sudoku_solver_tpu.ops.solve import solve_csp as jax_solve_csp
from distributed_sudoku_solver_tpu.utils.puzzles import make_puzzle
from distributed_sudoku_solver_tpu_torch.models import cover, nqueens, pentomino
from distributed_sudoku_solver_tpu_torch.models.geometry import SUDOKU_9, Geometry
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.ops import cuda_cover
from distributed_sudoku_solver_tpu_torch.ops.frontier import SolverConfig, init_frontier
from distributed_sudoku_solver_tpu_torch.ops.solve import finalize_frontier, solve_csp

LANES, SLOTS, TILE, K = 128, 4, 64, 4
NAMES = ("top", "stack", "has_top", "base", "count", "lane_solved", "lane_sol",
         "lane_overflow", "nodes", "sols", "live_rounds", "sweeps_total", "steps_max")

INSTANCES = {
    "nqueens8": (lambda: jnq.nqueens_cover(8), lambda: nqueens.nqueens_cover(8), 3),
    "pentomino3x20": (lambda: jpent.pentomino_cover(3, 20),
                      lambda: pentomino.pentomino_cover(3, 20), 3),
    "sudoku-cover4x4": (lambda: jcover.sudoku_cover(JGeometry(2, 2)),
                        lambda: cover.sudoku_cover(Geometry(2, 2)), 7),
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


def _random_states(jp, count, max_rows, rng):
    """``count`` states, each with up to ``max_rows`` random compatible rows taken."""
    elim = jcover._unpack_bits(jp.elim, jp.n_rows)
    out = []
    for _ in range(count):
        avail = np.ones(jp.n_rows, bool)
        rows = []
        for _ in range(rng.integers(0, max_rows + 1)):
            if not avail.any():
                break
            r = int(rng.choice(np.nonzero(avail)[0]))
            rows.append(r)
            avail &= ~elim[r]
            avail[r] = False
        out.append(jp.state_with_rows_taken(rows))
    return np.stack(out)  # uint32[count, 1, D]


def _round_inputs(jp, max_rows, seed):
    rng = np.random.default_rng(seed)
    states = _random_states(jp, LANES * (SLOTS + 1), max_rows, rng)
    d = states.shape[-1]
    states = states.reshape(LANES, SLOTS + 1, 1, d).view(np.int32)
    top = torch.from_numpy(np.ascontiguousarray(states[:, 0]))
    stack = torch.from_numpy(np.ascontiguousarray(states[:, 1:]))
    has = torch.from_numpy(rng.random(LANES) < 0.8)
    base = torch.from_numpy(rng.integers(0, SLOTS, LANES).astype(np.int32))
    count = torch.from_numpy(rng.integers(0, SLOTS + 1, LANES).astype(np.int32))
    return top, stack, has, base, count


def _jax_lane_first(out):
    """JAX 13-tuple ([1, D, L] tops) -> numpy, lane-first int32 patterns."""
    top_t, stack_t, *mid, sol_t, over, nodes, sols, live, sweeps, steps = (
        np.asarray(x) for x in out)
    return [top_t.transpose(2, 0, 1).view(np.int32),
            stack_t.transpose(3, 0, 1, 2).view(np.int32), *mid,
            sol_t.transpose(2, 0, 1).view(np.int32), over, nodes, sols, live, sweeps, steps]


def _chains_cut_short(tp, top, has, max_sweeps):
    """Live lanes whose forced chain ``max_sweeps`` cuts short in the first
    round: the capped fixpoint differs from the full one."""
    capped, sweeps = tp.propagate_per_lane(top, max_sweeps)
    full, _ = tp.propagate_per_lane(top, 64)
    cut = has & (capped != full).flatten(1).any(1)
    assert bool((sweeps[cut] == max_sweeps).all())
    return cut


@pytest.mark.parametrize("max_sweeps", [64, 1, 2])
@pytest.mark.parametrize("count_mode", [False, True])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_plain_cover_rounds_match_jax(name, count_mode, max_sweeps):
    make_j, make_t, max_rows = INSTANCES[name]
    jp, tp = make_j(), make_t()
    top, stack, has, base, count = _round_inputs(jp, max_rows, seed=len(name) + count_mode)
    if max_sweeps < 64:  # the cap path: re-scan after the cap, branch on a cnt == 1 column
        assert bool(_chains_cut_short(tp, top, has, max_sweeps).any())
    kw = dict(max_sweeps=max_sweeps, k_steps=K, tile=TILE, count_mode=count_mode)
    want = _jax_lane_first(jax_rounds(
        jnp.asarray(top.numpy().view(np.uint32).transpose(1, 2, 0)),
        jnp.asarray(stack.numpy().view(np.uint32).transpose(1, 2, 3, 0)),
        jnp.asarray(has.numpy()), jnp.asarray(base.numpy()), jnp.asarray(count.numpy()),
        jp, **kw))
    cuda_cover.cover_fused_rounds_cuda.launches = 0
    got = cuda_cover.cover_fused_rounds(top, stack.clone(), has, base, count, tp, **kw)
    assert cuda_cover.cover_fused_rounds_cuda.launches == 0  # CPU: plain version
    for field, g, w in zip(NAMES, got, want):
        if field != "sweeps_total":
            assert np.array_equal(g.numpy(), w), field
    live = got[10]
    assert int(got[12]) == int(live.max()) > 0
    # Idle lanes in tiles that ran come back as [0 x W_r, covered], as on the TPU.
    tile_max = live.reshape(-1, TILE).amax(1).repeat_interleave(TILE)
    idle = ~has & (tile_max > 0)
    assert bool(idle.any())
    assert not bool(got[0][idle, 0, : tp.w_rows].any())
    assert torch.equal(got[0][idle, 0, tp.w_rows :], top[idle, 0, tp.w_rows :])
    assert bool(got[0][idle, 0, tp.w_rows :].any())


def test_cover_sweeps_total_is_the_sum_of_each_lanes_own_sweeps():
    jp, tp = jnq.nqueens_cover(8), nqueens.nqueens_cover(8)
    top, stack, has, base, count = _round_inputs(jp, 2, seed=9)
    kw = dict(k_steps=K, count_mode=True)
    lanes = 24
    batched = cuda_cover.cover_fused_rounds(top[:lanes], stack[:lanes].clone(), has[:lanes],
                                            base[:lanes], count[:lanes], tp, tile=lanes, **kw)
    alone = 0
    for i in range(lanes):
        out = cuda_cover.cover_fused_rounds(top[i : i + 1], stack[i : i + 1].clone(),
                                            has[i : i + 1], base[i : i + 1],
                                            count[i : i + 1], tp, tile=1, **kw)
        alone += int(out[11])
    assert int(batched[11]) == alone > 0


def _roots(family, n):
    if family == "nqueens":
        jp, tp = jnq.nqueens_cover(n), nqueens.nqueens_cover(n)
        return jp, tp, jp.initial_state()[None]
    if family == "pentomino":
        jp, tp = jpent.pentomino_cover(3, 20), pentomino.pentomino_cover(3, 20)
        return jp, tp, jp.initial_state()[None]
    jg = JGeometry(2, 2)
    jp, tp = jcover.sudoku_cover(jg), cover.sudoku_cover(Geometry(2, 2))
    grids = [make_puzzle(jg, 90 + i, n_clues=5, unique=False) for i in range(5)]
    return jp, tp, np.stack([jp.state_with_rows_taken(jcover.sudoku_clue_rows(g))
                             for g in grids])


@pytest.mark.parametrize("case", [
    ("nqueens", 3, dict()),
    ("nqueens", 8, dict()),
    ("nqueens", 6, dict(count_all=True)),
    ("nqueens", 8, dict(count_all=True, lanes=200)),
    ("nqueens", 8, dict(count_all=True, lanes=1, min_lanes=1, stack_slots=2, steal=False)),
    ("pentomino", 0, dict(count_all=True, min_lanes=128, stack_slots=64, max_steps=200_000)),
    ("sudoku", 4, dict()),
    ("sudoku", 4, dict(count_all=True, fused_steps=3)),
], ids=lambda c: "-".join([f"{c[0]}{c[1]}", *(f"{k}={v}" for k, v in c[2].items())]))
def test_fused_cover_solve_matches_jax_except_sweeps(case):
    family, n, kw = case
    jp, tp, roots = _roots(family, n)
    base = dict(min_lanes=64, stack_slots=32, max_steps=40_000, step_impl="fused", fused_steps=4)
    jcfg = JSolverConfig(**{**base, **kw})
    want = jax_solve_csp(jnp.asarray(roots), jp, jcfg)
    got = solve_csp(roots, tp, SolverConfig.from_fields(jcfg), device="cpu")
    for f in want._fields:
        if f == "sweeps":
            continue
        w = np.asarray(getattr(want, f))
        assert np.array_equal(getattr(got, f).numpy(), w.view(np.int32) if w.dtype == np.uint32
                              else w), f
    assert int(got.sweeps) > 0
    if family == "pentomino":
        assert int(got.sol_count[0]) == 8 and bool(got.unsat[0])
    if kw.get("stack_slots") == 2:
        assert bool(got.overflowed[0]) and int(got.sol_count[0]) < 92


def test_stepped_advance_gives_the_one_shot_verdicts():
    tp = nqueens.nqueens_cover(7)
    roots = torch.from_numpy(np.repeat(tp.initial_state()[None], 2, axis=0))
    cfg = SolverConfig(min_lanes=64, stack_slots=32, max_steps=40_000, step_impl="fused",
                       count_all=True)
    one_shot = solve_csp(roots, tp, cfg, device="cpu")
    state = init_frontier(roots, dataclasses.replace(cfg, lanes=64))
    limit = 0
    while True:
        limit += 10
        before = int(state.steps)
        state = cuda_cover.advance_cover_fused(state, limit, tp, cfg)
        if int(state.steps) == before:
            break
        assert int(state.steps) < limit + 8  # overshoot below one dispatch
    stepped = finalize_frontier(state)
    for f in one_shot._fields:
        assert torch.equal(getattr(stepped, f), getattr(one_shot, f)), f
    assert one_shot.sol_count.tolist() == [40, 40] and bool(one_shot.unsat.all())


def _synthetic(rows, primary, cols_full):
    """Fields of an instance of the given size.  Admission reads only the
    sizes and word widths, so each array keeps one leading row."""
    w_r, w_c = -(-rows // 32), -(-primary // 32)
    return dict(name=f"synthetic{rows}x{primary}", n_rows=rows, n_primary=primary,
                col_rows=np.zeros((1, w_r), np.uint32), row_cols=np.zeros((1, w_c), np.uint32),
                elim=np.zeros((1, w_r), np.uint32),
                incidence=np.zeros((1, -(-cols_full // 32)), np.uint32),
                n_cols_full=cols_full, max_sweeps=64)


def test_admission_takes_every_instance_the_jax_kernel_takes():
    # Both admit the published instances.
    for jp in (jnq.nqueens_cover(14), jpent.pentomino_cover(6, 10),
               jcover.sudoku_cover(JGeometry(3, 3))):
        jax_cover_consts(jp)
        assert cuda_cover.launch_shape(cover.cover_from_numpy(jp)).warps > 0
    # Sudoku-cover 16x16's shape: the JAX kernel refuses it (keys past its
    # f32-exact 2**22 sentinel), the port's int32 keys take it.
    fields = _synthetic(4096, 1024, 1024)
    with pytest.raises(ValueError, match="sentinel"):
        jax_cover_consts(jcover.ExactCoverCSP(**fields))
    shape = cuda_cover.launch_shape(cover.cover_from_numpy(fields))
    assert shape.warps == 8 and shape.smem_bytes <= cuda_cover.SMEM_BYTES
    # The port refuses keys past int32 and a lane state over a block's shared memory.
    for rows, primary in ((70_000, 40_000), (2_000_000, 1)):
        with pytest.raises(ValueError, match="cannot serve"):
            cuda_cover.launch_shape(cover.cover_from_numpy(_synthetic(rows, primary, primary)))
    legacy = dict(_synthetic(64, 8, 8), incidence=None, n_cols_full=0)
    with pytest.raises(ValueError, match="incidence"):
        cuda_cover.launch_shape(cover.cover_from_numpy(legacy))
    # The fused solve admits before its first dispatch, and needs a stack slot.
    with pytest.raises(ValueError, match="incidence"):
        solve_csp(np.zeros((1, 1, 3), np.int32), cover.cover_from_numpy(legacy),
                  SolverConfig(min_lanes=16, step_impl="fused"), device="cpu")
    tp = nqueens.nqueens_cover(4)
    with pytest.raises(ValueError, match="slot"):
        solve_csp(tp.initial_state()[None], tp,
                  SolverConfig(min_lanes=16, stack_slots=0, step_impl="fused"), device="cpu")
    assert [cuda_cover.cover_fused_lanes(n) for n in (1, 128, 129, 4000)] == [1, 128, 256, 4096]


def test_fused_solve_csp_rejects_other_families():
    with pytest.raises(ValueError, match="exact-cover"):
        solve_csp(np.zeros((1, 9, 9), np.int32), SudokuCSP(SUDOKU_9),
                  SolverConfig(min_lanes=16, step_impl="fused"), device="cpu")
