"""K2: whole frontier rounds as a hand-written CUDA kernel, its plain version, and the driver.

Port of the JAX package's ``ops/pallas_step.py`` (``fused_rounds`` and its
XLA driver).  :func:`fused_rounds` advances every lane up to ``k_steps``
rounds (fixpoint, classify, branch, push/pop on the lane's circular stack,
first-solution capture, overflow) and returns the JAX 13-tuple ``(top,
stack, has_top, base, count, lane_solved, lane_sol, lane_overflow,
nodes_delta, sols_delta, live_rounds_delta, sweeps_total, steps_max)``.

Layout: lane-first, ``top`` ``int32[L, n, n]`` and ``stack``
``int32[L, S, n, n]`` (uint32 patterns), the layout of ``ops.frontier``.
The JAX kernel's boards-last ``[n, n, L]`` transposes existed for the
TPU's vector compiler; with one warp per lane a contiguous board is the
natural layout on the GPU.  Tests transpose JAX's boards-last tensors
before comparing.  ``stack`` is updated in place and returned (the JAX
driver donates it).

Semantics against the TPU kernel's 128-lane tiles: the kernel here
converges per lane, a lane running until it dies or ``k_steps`` rounds.
Per-lane convergence changes no lane's masks, stack, counters or flags
(a sweep of a fixpoint is the identity, and a dead lane changes nothing
but its top), so ``steps_max`` is ``max(live_rounds)`` as on the TPU.  The
one visible tile effect, a dead lane's top cleared to 0 while its tile
runs on, is reproduced after the launch for tiles of ``tile`` lanes.
``sweeps_total`` is the one field that depends on tiling: the port
defines it as the sum over lanes of each lane's own sweeps (the TPU summed
per-tile sweeps), so it is left out of bit-equality with the JAX path.

:func:`fused_rounds` takes the plain version (:func:`fused_rounds_plain`)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``fused_rounds_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.ops import cuda_build, ordering
from distributed_sudoku_solver_tpu_torch.ops.bitmask import (
    is_single,
    lowest_bit,
    once_twice_reduce,
    or_reduce,
    popcount,
)
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    FUSED_STEPS_DEVICE,
    _scatter_add,
    _scatter_min,
    _scatter_max_bool,
    _set_rows,
    _steal,
    _write_rows,
    chunk_status,
    init_frontier,
    megastep_chunks,
)
from distributed_sudoku_solver_tpu_torch.ops.propagate import (
    RULE_TIERS,
    _unit_views,
    propagate_per_board,
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_round_inputs(top, stack, has_top, base, count, geom, rules, branch_rule):
    if rules not in RULE_TIERS:
        raise ValueError(f"unknown rules {rules!r}")
    ordering.validate_branch(branch_rule)
    n = geom.n
    if top.ndim != 3 or tuple(top.shape[1:]) != (n, n):
        raise ValueError(f"top must be [L, {n}, {n}], got {tuple(top.shape)}")
    lanes = top.shape[0]
    if stack.ndim != 4 or stack.shape[0] != lanes or tuple(stack.shape[2:]) != (n, n):
        raise ValueError(f"stack must be [{lanes}, S, {n}, {n}], got {tuple(stack.shape)}")
    if stack.shape[1] < 1:
        raise ValueError("stack needs at least one slot")
    for name, v in (("has_top", has_top), ("base", base), ("count", count)):
        if tuple(v.shape) != (lanes,):
            raise ValueError(f"{name} must be [{lanes}], got {tuple(v.shape)}")
    for name, v in (("top", top), ("stack", stack)):
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {v.dtype}")


def _tile_clear(top: torch.Tensor, live_rounds: torch.Tensor, tile: int,
                words: int | None = None) -> torch.Tensor:
    """Clear the top of each lane that was dead in a round its ``tile``-lane
    tile still ran (fewer live rounds than the tile's busiest lane); with
    ``words``, only the first ``words`` entries of the last axis."""
    lanes = top.shape[0]
    if lanes == 0:
        return top
    t = min(tile, lanes)
    if lanes % t:
        raise ValueError(f"lanes {lanes} not a multiple of tile {t}")
    tile_max = live_rounds.reshape(-1, t).amax(1).repeat_interleave(t)
    dead = (live_rounds < tile_max).reshape(-1, *([1] * (top.ndim - 1)))
    if words is not None:
        dead = dead & (torch.arange(top.shape[-1], device=top.device) < words)
    return torch.where(dead, torch.zeros_like(top), top)


def status_full(cand: torch.Tensor, geom: Geometry) -> tuple[torch.Tensor, torch.Tensor]:
    """The round's classification: ``ops.propagate.board_status`` with the
    duplicate test as the JAX fused kernel states it (a decided digit seen
    twice in a unit).  Returns bool ``(solved, contradiction)``."""
    single = is_single(cand)
    decided = torch.where(single, cand, torch.zeros_like(cand))
    bad = (cand == 0).flatten(-2).any(-1)
    for (view, _), (dview, _) in zip(_unit_views(cand, geom), _unit_views(decided, geom)):
        _, twice = once_twice_reduce(dview, -1)
        bad = bad | (twice != 0).any(-1) | (or_reduce(view, -1) != geom.full_mask_i32).any(-1)
    solved = single.flatten(-2).all(-1) & ~bad
    return solved, bad


def _plain_rounds(top, stack, has_top, base, count, propagate, status, branch,
                  k_steps: int, tile: int, count_mode: bool, words: int | None = None):
    """The round loop of the plain versions of K2 and K3.  The family gives
    ``propagate(tops) -> (tops, per-lane sweeps)``, ``status(tops) ->
    (solved, contradiction)`` and ``branch(tops) -> (guess, rest)``;
    ``words`` goes to :func:`_tile_clear`."""
    lanes, s = stack.shape[:2]
    dev = top.device
    lane_idx = torch.arange(lanes, dtype=torch.int32, device=dev)
    zeros_l = torch.zeros(lanes, dtype=torch.int32, device=dev)
    top = top.clone()
    has = has_top.to(torch.bool).clone()
    count = count.to(torch.int32).clone()
    base = base.to(torch.int32).clone()
    sol = torch.zeros_like(top)
    zero_b = torch.zeros_like(top)
    solved_f = torch.zeros(lanes, dtype=torch.bool, device=dev)
    over_f = torch.zeros_like(solved_f)
    nodes, sols, live_r, sweeps = (zeros_l.clone() for _ in range(4))
    for _ in range(k_steps):
        live = has
        if not bool(live.any()):
            break
        tops, lane_sweeps = propagate(torch.where(live[:, None, None], top, zero_b))
        live_r += live.to(torch.int32)
        sweeps += torch.where(live, lane_sweeps, zeros_l)
        slv, con = status(tops)
        top_solved = slv & live
        top_contra = con & live
        newly = top_solved & ~solved_f
        sol = torch.where(newly[:, None, None], tops, sol)
        solved_f = solved_f | newly
        if count_mode:
            sols += top_solved.to(torch.int32)
        undecided = live & ~top_solved & ~top_contra
        guess, rest = branch(tops)
        can_push = undecided & (count < s)
        _write_rows(stack, lane_idx, (base + count) % s, can_push, rest)
        over_f = over_f | (undecided & ~can_push)
        nodes += undecided.to(torch.int32)
        resolved = (top_solved | top_contra) if count_mode else top_contra
        can_pop = resolved & (count > 0)
        popped = stack[lane_idx.long(), ((base + count - 1) % s).long()]
        new_top = torch.where(undecided[:, None, None], guess, tops)
        new_top = torch.where(can_pop[:, None, None], popped, new_top)
        top = torch.where(live[:, None, None], new_top, top)
        has = live & ~(resolved & ~can_pop)
        if not count_mode:
            has = has & ~top_solved
        count = count + can_push.to(torch.int32) - can_pop.to(torch.int32)
    steps_max = live_r.max() if lanes else torch.zeros((), dtype=torch.int32, device=dev)
    return (
        _tile_clear(top, live_r, tile, words), stack, has, base, count, solved_f, sol, over_f,
        nodes, sols, live_r, sweeps.sum(dtype=torch.int32), steps_max.to(torch.int32),
    )


def _kernel_outputs(top_out, stack, base, sol, lane_out, tile: int, words: int | None = None):
    """The 13-tuple from a round kernel's outputs.  ``lane_out`` rows (the
    layout both K2 and K3 write): has, count, solved, overflow, nodes,
    sols, live rounds, sweeps."""
    has, cnt, solved, over, nodes, sols, live, sweeps = lane_out.unbind(0)
    steps_max = live.max() if live.numel() else torch.zeros(
        (), dtype=torch.int32, device=live.device)
    return (
        _tile_clear(top_out, live, tile, words), stack, has > 0, base.clone(), cnt, solved > 0,
        sol, over > 0, nodes, sols, live, sweeps.sum(dtype=torch.int32), steps_max,
    )


def head_branch_full(cand: torch.Tensor, geom: Geometry, rule: str):
    """The fused round's branch under a scored head: the key from the
    head's ``score_full`` (its separately rounded f32 chain, not the
    composite step's matrix product), the lowest candidate digit as the
    guess.  Returns ``(guess, rest)``."""
    head = ordering.get_head(rule)
    n, lanes = geom.n, cand.shape[0]
    cell = torch.arange(n * n, dtype=torch.int32, device=cand.device)
    score = head.score_full(cand, geom, lambda x: ordering._unit_sums_lanes(x, geom))
    key = ordering.pack_key(score.reshape(lanes, n * n), popcount(cand).reshape(lanes, n * n) > 1,
                            cell, n, head.quant)
    onehot = (cell[None, :] == torch.argmin(key, dim=-1)[:, None]).reshape(lanes, n, n)
    pick = lowest_bit(cand)
    return torch.where(onehot, pick, cand), torch.where(onehot, cand & ~pick, cand)


def fused_rounds_plain(
    top, stack, has_top, base, count, geom: Geometry, rules: str = "extended",
    branch_rule: str = "minrem", max_sweeps: int = 64, k_steps: int = 8,
    tile: int = 128, count_mode: bool = False, sweep_unroll: int = 2,
):
    """Plain torch re-statement of the round kernel, on any device."""
    _check_round_inputs(top, stack, has_top, base, count, geom, rules, branch_rule)
    if ordering.is_head_rule(branch_rule):
        branch = lambda b: head_branch_full(b, geom, branch_rule)  # noqa: E731
    else:
        branch = SudokuCSP(geom, branch_rule, max_sweeps, "xla", rules).branch
    return _plain_rounds(
        top, stack, has_top, base, count,
        lambda b: propagate_per_board(b, geom, max_sweeps, rules, unroll=sweep_unroll),
        lambda b: status_full(b, geom), branch, k_steps, tile, count_mode,
    )


def rule_code(branch_rule: str) -> int:
    """K2's code of a branch rule: the legacy rules 0-3, then the heads."""
    if ordering.is_head_rule(branch_rule):
        return len(ordering.LEGACY_RULES) + ordering.HEAD_NAMES.index(
            branch_rule[len("head:"):])
    return ordering.LEGACY_RULES.index(branch_rule)


def head_params(branch_rule: str, geom: Geometry):
    """K2's ``HeadParams`` image (``csrc/fixpoint.cuh``) for a head rule,
    as float32 numpy: the MLP's w1 [7][8], b1, w2, then b2 + 8 (summed in
    double), 1/n, 1/n^2, the quant and pack_key's bound, each rounded to
    f32 once, as JAX rounds its Python floats.  ``None`` for a legacy rule."""
    if not ordering.is_head_rule(branch_rule):
        return None
    head = ordering.get_head(branch_rule)
    n = geom.n
    if isinstance(head, ordering.MlpHead):
        if len(head.w1) != 7 or any(len(r) != 8 for r in head.w1) or len(head.b1) != 8 \
                or len(head.w2) != 8:
            raise ValueError("K2 takes an MLP head of 7 features and 8 hidden units")
        mlp = [v for row in head.w1 for v in row] + list(head.b1) + list(head.w2) + [
            head.b2 + 8.0]
    else:
        mlp = [0.0] * (7 * 8 + 8 + 8 + 1)
    return np.asarray(mlp + [1.0 / n, 1.0 / (n * n), head.quant, ordering._qmax(n)],
                      dtype=np.float32)


STAGES = ("elimination", "hidden singles", "box-line", "naked subsets", "status",
          "branch", "push and pop", "total")


def _lib(variant: str = ""):
    lib = cuda_build.load("fused_step", variant)
    fn = lib.dsst_fused_rounds
    fn.argtypes = [_P] * 8 + [_I] * 10 + [_P, _P]
    fn.restype = _I
    return lib


def _launch(variant, top, stack, has_top, base, count, geom, rules, branch_rule, max_sweeps,
            k_steps, tile, count_mode, sweep_unroll):
    _check_round_inputs(top, stack, has_top, base, count, geom, rules, branch_rule)
    for name, v in (("top", top), ("stack", stack), ("has_top", has_top),
                    ("base", base), ("count", count)):
        if v.device.type != "cuda":
            raise ValueError(f"fused_rounds_cuda needs CUDA tensors; {name} is on {v.device}")
    if not (top.is_contiguous() and stack.is_contiguous()):
        raise ValueError("fused_rounds_cuda needs contiguous top and stack")
    if max(k_steps, max_sweeps, sweep_unroll) >= 2**31 or k_steps < 0:
        raise ValueError("k_steps / max_sweeps / sweep_unroll out of int32 range")
    lib = _lib(variant)
    lanes, s = stack.shape[:2]
    dev = top.device
    has_i = has_top.to(torch.int32).contiguous()
    base_i = base.to(torch.int32).contiguous()
    count_i = count.to(torch.int32).contiguous()
    top_out = torch.empty_like(top)
    sol = torch.empty_like(top)
    lane_out = torch.empty((8, lanes), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    params = head_params(branch_rule, geom)  # host memory, copied at the launch
    err = lib.dsst_fused_rounds(
        top.data_ptr(), stack.data_ptr(), has_i.data_ptr(), base_i.data_ptr(),
        count_i.data_ptr(), top_out.data_ptr(), sol.data_ptr(), lane_out.data_ptr(),
        lanes, s, geom.box_h, geom.box_w, RULE_TIERS.index(rules), rule_code(branch_rule),
        max_sweeps, k_steps, int(count_mode), sweep_unroll,
        None if params is None else params.ctypes.data, stream)
    cuda_build.check(err, "dsst_fused_rounds")
    return _kernel_outputs(top_out, stack, base_i, sol, lane_out, tile)


def fused_rounds_cuda(
    top, stack, has_top, base, count, geom: Geometry, rules: str = "extended",
    branch_rule: str = "minrem", max_sweeps: int = 64, k_steps: int = 8,
    tile: int = 128, count_mode: bool = False, sweep_unroll: int = 2,
):
    """Launch K2 on CUDA tensors (no host sync); same returns as the plain version."""
    out = _launch("", top, stack, has_top, base, count, geom, rules, branch_rule,
                  max_sweeps, k_steps, tile, count_mode, sweep_unroll)
    fused_rounds_cuda.launches += 1
    return out


def fused_rounds_stage_cycles(
    top, stack, has_top, base, count, geom: Geometry, rules: str = "extended",
    branch_rule: str = "minrem", max_sweeps: int = 64, k_steps: int = 8,
    count_mode: bool = False, sweep_unroll: int = 2, reps: int = 1,
) -> dict[str, int]:
    """K2's counter build (``csrc/fixpoint.cuh``, ``-DDSST_STAGE_CLOCKS``)
    launched ``reps`` times on the same inputs (``stack`` is cloned for each,
    so every launch does the same work); returns the ``clock64()`` cycles
    that all warps spent in each stage of :data:`STAGES`, summed over warps
    and launches.  Synchronizes.  Not a main-path launch: the package runs
    the library without counters, and this does not count in
    ``fused_rounds_cuda.launches``."""
    take = _lib("clocks").dsst_stage_cycles_take
    take.argtypes = [_P]
    take.restype = _I
    cycles = np.zeros(len(STAGES), dtype=np.uint64)
    torch.cuda.synchronize(top.device)
    cuda_build.check(take(cycles.ctypes.data), "dsst_stage_cycles_take")  # zero it
    for _ in range(reps):
        _launch("clocks", top, stack.clone(), has_top, base, count, geom, rules, branch_rule,
                max_sweeps, k_steps, 128, count_mode, sweep_unroll)
    torch.cuda.synchronize(top.device)
    cuda_build.check(take(cycles.ctypes.data), "dsst_stage_cycles_take")
    return {name: int(c) for name, c in zip(STAGES, cycles)}


fused_rounds_cuda.launches = 0


def fused_rounds(top, stack, has_top, base, count, geom: Geometry, **kw):
    """Advance every lane up to ``k_steps`` rounds (see the module docstring).

    CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if top.device.type == "cpu":
        return fused_rounds_plain(top, stack, has_top, base, count, geom, **kw)
    return fused_rounds_cuda(top, stack, has_top, base, count, geom, **kw)


# -- driver: job bookkeeping and stealing between dispatches ---------------------


class FusedFrontier(NamedTuple):
    """Loop state of the fused driver: the JAX ``FusedFrontier`` fields,
    lane-first (``top`` / ``stack`` / ``solution`` for its boards-last
    ``top_t`` / ``stack_t`` / ``solution_t``)."""

    top: torch.Tensor  # int32[L, n, n]
    stack: torch.Tensor  # int32[L, S, n, n]
    has_top: torch.Tensor  # bool[L]
    base: torch.Tensor  # int32[L]
    count: torch.Tensor  # int32[L]
    job: torch.Tensor  # int32[L]
    solved: torch.Tensor  # bool[J]
    solution: torch.Tensor  # int32[J, n, n]
    overflowed: torch.Tensor  # bool[J]
    nodes: torch.Tensor  # int32[J]
    sol_count: torch.Tensor  # int32[J]
    steps: torch.Tensor  # int32 0-d
    sweeps: torch.Tensor  # int32 0-d
    expansions: torch.Tensor  # int32 0-d
    steals: torch.Tensor  # int32 0-d
    lane_rounds: torch.Tensor  # int32[L]


def frontier_to_fused(state) -> FusedFrontier:
    """``ops.frontier.Frontier`` -> :class:`FusedFrontier` (same tensors)."""
    d = state._asdict()
    return FusedFrontier(**{k: d[k] for k in FusedFrontier._fields})


def fused_to_frontier(fs: FusedFrontier):
    """:class:`FusedFrontier` -> ``ops.frontier.Frontier`` (same tensors)."""
    from distributed_sudoku_solver_tpu_torch.ops.frontier import Frontier

    d = fs._asdict()
    return Frontier(**{k: d[k] for k in Frontier._fields})


def fused_lanes(n_lanes: int, n: int, stack_slots: int) -> int:
    """Round ``n_lanes`` up to the lane count the fused path uses.

    Up to 128 lanes stay as they are; beyond, the count rounds up to a
    multiple of 128, as in the JAX package, because the lane count decides
    where roots are seeded (so it is part of parity).  The kernel admits any
    stack depth that fits device memory; a depth it cannot take raises."""
    if stack_slots < 1:
        raise ValueError(f"step_impl='fused' needs stack_slots >= 1, got {stack_slots}")
    if not 1 <= n <= 32:
        raise ValueError(f"step_impl='fused' takes 1 <= n <= 32, got n={n}")
    if n_lanes <= 128:
        return n_lanes
    return -(-n_lanes // 128) * 128


def _fused_live(fs) -> torch.Tensor:
    n_jobs = fs.solved.shape[0]
    job_safe = torch.clamp(fs.job, 0, n_jobs - 1).long()
    return fs.has_top & (fs.job >= 0) & ~fs.solved[job_safe]


def _fused_round(fs: FusedFrontier, geom: Geometry | None, config, rounds_fn=None) -> FusedFrontier:
    """One kernel dispatch (``fused_steps`` rounds) + the job bookkeeping.

    ``rounds_fn`` (FusedFrontier -> the 13-tuple of :func:`fused_rounds`)
    swaps in another round kernel: the exact-cover kernel
    (``ops/cuda_cover.py``) shares harvest, purge and steal this way;
    ``None`` dispatches the Sudoku kernel on ``geom``."""
    n_jobs = fs.solved.shape[0]
    n_lanes = fs.has_top.shape[0]
    dev = fs.has_top.device
    job_safe = torch.clamp(fs.job, 0, n_jobs - 1).long()
    if rounds_fn is None:
        rounds_fn = lambda f: fused_rounds(  # noqa: E731
            f.top, f.stack, f.has_top, f.base, f.count, geom,
            rules=config.rules, branch_rule=config.branch, max_sweeps=config.max_sweeps,
            k_steps=config.fused_steps, tile=min(128, n_lanes),
            count_mode=config.count_all, sweep_unroll=config.fused_sweep_unroll,
        )
    (top, stack, has_top, base, count, lane_solved, lane_sol, lane_over, nodes_d,
     sols_d, liv_d, sweeps_t, steps_m) = rounds_fn(fs)

    live_jobs = fs.job >= 0
    lane_ids = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    no_lane = torch.full_like(lane_ids, n_lanes)
    no_job = torch.full_like(lane_ids, n_jobs)
    if config.count_all:
        sol_count = _scatter_add(fs.sol_count, torch.where(live_jobs, fs.job, no_job), sols_d)
        had_sol = fs.sol_count > 0
        eligible = lane_solved & live_jobs & ~had_sol[job_safe]
    else:
        had_sol = fs.solved
        eligible = lane_solved & live_jobs & ~fs.solved[job_safe]
    first = _scatter_min(
        n_jobs, n_lanes, torch.where(eligible, fs.job, no_job),
        torch.where(eligible, lane_ids, no_lane),
    )
    newly = (first < n_lanes) & ~had_sol
    sol_rows = lane_sol[torch.clamp(first, 0, n_lanes - 1).long()]
    solution = torch.where(newly[:, None, None], sol_rows, fs.solution)
    if config.count_all:
        solved = fs.solved
    else:
        solved = fs.solved | newly
        sol_count = solved.to(torch.int32)

    overflowed = _set_rows(fs.overflowed, torch.where(lane_over & live_jobs, fs.job, no_job), True)
    nodes = _scatter_add(fs.nodes, torch.where(live_jobs, fs.job, no_job), nodes_d)

    job_live = live_jobs & ~solved[job_safe]
    has_top = has_top & job_live
    count = torch.where(job_live, count, torch.zeros_like(count))
    job = fs.job
    n_steals = torch.zeros((), dtype=torch.int32, device=dev)
    if config.steal:
        top, has_top, base, count, job, n_steals = _steal(
            top, has_top, stack, base, count, job, job_live, gang=config.steal_gang,
        )

    return FusedFrontier(
        top=top, stack=stack, has_top=has_top, base=base, count=count, job=job,
        solved=solved, solution=solution, overflowed=overflowed, nodes=nodes,
        sol_count=sol_count, steps=fs.steps + steps_m, sweeps=fs.sweeps + sweeps_t,
        expansions=fs.expansions + nodes_d.sum(dtype=torch.int32),
        steals=fs.steals + n_steals, lane_rounds=fs.lane_rounds + liv_d,
    )


def _run_fused(fs: FusedFrontier, geom: Geometry | None, config, limit: int,
               rounds_fn=None) -> FusedFrontier:
    """Dispatch fused rounds until nothing is live or ``steps`` reaches
    ``limit`` (overshooting by up to ``fused_steps - 1``, as in JAX).
    One host sync per dispatch reads the loop condition.  ``rounds_fn``
    swaps the round kernel (see :func:`_fused_round`)."""
    while bool(_fused_live(fs).any() & (fs.steps < limit)):
        fs = _fused_round(fs, geom, config, rounds_fn)
    return fs


def _advance_fused(state, step_limit: int, geom: Geometry, config):
    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    limit = min(int(step_limit), config.max_steps)
    return fused_to_frontier(_run_fused(frontier_to_fused(state), geom, config, limit))


def advance_frontier_fused(state, step_limit, geom: Geometry, config):
    """Fused twin of ``utils.checkpoint.advance_frontier`` (lane-first
    ``Frontier`` in and out; its stack is updated in place)."""
    return _advance_fused(state, step_limit, geom, config)


def advance_frontier_fused_status(state, steps_delta, geom: Geometry, config):
    """Fused twin of ``utils.checkpoint.advance_frontier_status``: advance
    by at most ``steps_delta`` more rounds; returns ``(state, status)``."""
    new = _advance_fused(state, int(state.steps) + int(steps_delta), geom, config)
    return new, chunk_status(state.steps, state.lane_rounds, new)


def advance_megastep_fused(state, chunk_steps: int, max_chunks: int, geom: Geometry, config):
    """Fused twin of ``ops.frontier.advance_megastep``: one latency-mode
    flight of K2 dispatches in chunks of ``chunk_steps`` rounds, with the
    same flight-start status baselines and early exit; returns
    ``(state, status, chunks)``.  The host reads the loop condition once
    per dispatch and once per chunk (JAX: once per flight)."""
    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    fs, status, chunks = megastep_chunks(
        frontier_to_fused(state), lambda f, limit: _run_fused(f, geom, config, limit),
        chunk_steps, max_chunks, config.max_steps,
    )
    return fused_to_frontier(fs), status, chunks


def solve_batch_fused(grids: torch.Tensor, geom: Geometry, config):
    """Fused-step batched Sudoku solve (``SolverConfig.step_impl='fused'``),
    the contract of ``ops.solve.solve_batch`` under fused round semantics."""
    from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
    from distributed_sudoku_solver_tpu_torch.ops.solve import SolveResult, _decode_solution

    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    n_jobs = grids.shape[0]
    lanes = fused_lanes(config.resolve_lanes(n_jobs), geom.n, config.stack_slots)
    config = dataclasses.replace(config, lanes=lanes)
    state = init_frontier(encode_grid(grids, geom), config)
    fs = _run_fused(frontier_to_fused(state), geom, config, config.max_steps)

    job_safe = torch.clamp(fs.job, 0, n_jobs - 1)
    job_has_work = _scatter_max_bool(n_jobs, job_safe, _fused_live(fs))
    unsat = ~fs.solved & ~job_has_work & ~fs.overflowed
    res = SolveResult(
        solution=fs.solution, solved=fs.solved, unsat=unsat, overflowed=fs.overflowed,
        nodes=fs.nodes, sol_count=fs.sol_count, steps=fs.steps, sweeps=fs.sweeps,
        expansions=fs.expansions, steals=fs.steals,
    )
    return _decode_solution(res)
