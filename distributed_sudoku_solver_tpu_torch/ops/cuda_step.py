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

The fused loop (:func:`_run_fused`) dispatches the kernel and then does the
job bookkeeping between dispatches (harvest, purge, steal, counters).  On
CUDA tensors that bookkeeping is one replay of a captured CUDA graph a
dispatch (:class:`_RoundGraph`); the kernel itself is still launched by a
Python call through :func:`fused_rounds` every dispatch.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.obs import lockdep, trace
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
    per_tile = live_rounds.reshape(-1, t)
    dead = (per_tile < per_tile.amax(1, keepdim=True)).reshape(-1, *([1] * (top.ndim - 1)))
    if words is None:
        return top.masked_fill(dead, 0)
    return torch.cat([top[..., :words].masked_fill(dead, 0), top[..., words:]], dim=-1)


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
    lane_out = torch.stack([has.to(torch.int32), count, solved_f.to(torch.int32),
                            over_f.to(torch.int32), nodes, sols, live_r, sweeps])
    return _kernel_outputs(top, stack, base, sol, lane_out, tile, words)


class KernelOut(NamedTuple):
    """A round's own outputs, in the buffers a caller passed as ``out``:
    the lanes' tops before the tile clear, their first solutions and the
    eight rows of ``lane_out``; ``tile`` and ``words`` are what
    :func:`_kernel_outputs` takes to make the 13-tuple of them."""

    top: torch.Tensor
    sol: torch.Tensor
    lane_out: torch.Tensor
    tile: int
    words: int | None


def _out_buffers(top: torch.Tensor, out=None) -> tuple:
    """The buffers a round writes its own outputs into: ``out`` (the
    tops, the solutions and ``lane_out``), checked against ``top``'s lanes,
    or new ones."""
    want = ((top.shape, top.dtype), (top.shape, top.dtype),
            ((8, top.shape[0]), torch.int32))
    if out is None:
        return tuple(torch.empty(shape, dtype=dtype, device=top.device) for shape, dtype in want)
    for buf, (shape, dtype) in zip(out, want):
        if (buf.shape != shape or buf.dtype != dtype or buf.device != top.device
                or not buf.is_contiguous()):
            raise ValueError(f"out buffer {tuple(buf.shape)} {buf.dtype} on {buf.device} "
                             f"does not fit {tuple(shape)} {dtype} on {top.device}")
    return tuple(out)


def _round_outputs(top, stack, base, sol, lane_out, tile: int, words, out):
    """A kernel's returns: the 13-tuple (:func:`_kernel_outputs`), or with
    ``out`` (where the kernel wrote its own outputs) a :class:`KernelOut`."""
    if out is None:
        return _kernel_outputs(top, stack, base, sol, lane_out, tile, words)
    return KernelOut(*out, tile, words)


def _kernel_outputs(top_out, stack, base, sol, lane_out, tile: int, words: int | None = None):
    """The 13-tuple from a round's own outputs.  ``lane_out`` rows (the
    layout both K2 and K3 write): has, count, solved, overflow, nodes,
    sols, live rounds, sweeps."""
    _, cnt, _, _, nodes, sols, live, sweeps = lane_out.unbind(0)
    has, _, solved, over = (lane_out[:4] > 0).unbind(0)
    steps_max = live.max() if live.numel() else torch.zeros(
        (), dtype=torch.int32, device=live.device)
    return (
        _tile_clear(top_out, live, tile, words), stack, has, base.clone(), cnt, solved,
        sol, over, nodes, sols, live, sweeps.sum(dtype=torch.int32), steps_max,
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
            k_steps, tile, count_mode, sweep_unroll, out=None):
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
    top_out, sol, lane_out = _out_buffers(top, out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    params = head_params(branch_rule, geom)  # host memory, copied at the launch
    err = lib.dsst_fused_rounds(
        top.data_ptr(), stack.data_ptr(), has_i.data_ptr(), base_i.data_ptr(),
        count_i.data_ptr(), top_out.data_ptr(), sol.data_ptr(), lane_out.data_ptr(),
        lanes, s, geom.box_h, geom.box_w, RULE_TIERS.index(rules), rule_code(branch_rule),
        max_sweeps, k_steps, int(count_mode), sweep_unroll,
        None if params is None else params.ctypes.data, stream)
    cuda_build.check(err, "dsst_fused_rounds")
    return _round_outputs(top_out, stack, base_i, sol, lane_out, tile, None, out)


def fused_rounds_cuda(
    top, stack, has_top, base, count, geom: Geometry, rules: str = "extended",
    branch_rule: str = "minrem", max_sweeps: int = 64, k_steps: int = 8,
    tile: int = 128, count_mode: bool = False, sweep_unroll: int = 2, out=None,
):
    """Launch K2 on CUDA tensors (no host sync); same returns as the plain
    version.  With ``out`` (three buffers: tops, solutions, ``lane_out``)
    the kernel writes its own outputs there and the call returns them as a
    :class:`KernelOut`, for a caller that makes the 13-tuple later
    (:class:`_RoundGraph`, inside its graph)."""
    res = _launch("", top, stack, has_top, base, count, geom, rules, branch_rule,
                  max_sweeps, k_steps, tile, count_mode, sweep_unroll, out)
    fused_rounds_cuda.launches += 1
    return res


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


# K2 takes its lane count as a C ``int`` and sizes its grid as ``(lanes + 3)
# / 4`` in ``int`` (``csrc/fused_step.cu``, 4 warps a block): the widest
# 128-multiple of lanes for which neither overflows.
_K2_MAX_LANES = ((2**31 - 1) - 3) // 128 * 128


def max_fused_lanes(n: int, stack_slots: int) -> int:
    """Widest lane count one K2 flight serves at ``(n, stack_slots)``; 0 =
    none (:func:`fused_lanes` raises for that shape).

    The JAX package's counterpart returns the scoped-VMEM boundaries that
    Mosaic's compiler was measured to admit per (geometry, stack depth),
    and 0 past them.  K2 keeps no stack on chip: each lane's stack lives in
    device memory and one warp serves one lane, so the only cap is the
    range of the kernel's ``int`` lane count, the same at every geometry
    and depth it admits.  The serving engine therefore never splits or
    downgrades a fused group on a shape the TPU would have refused."""
    try:
        fused_lanes(1, n, stack_slots)
    except ValueError:
        return 0
    return _K2_MAX_LANES


def _fused_live(fs) -> torch.Tensor:
    n_jobs = fs.solved.shape[0]
    job_safe = torch.clamp(fs.job, 0, n_jobs - 1).long()
    return fs.has_top & (fs.job >= 0) & ~fs.solved[job_safe]


def _round_kernel(fs: FusedFrontier, geom: Geometry | None, config, rounds_fn=None,
                  out=None) -> tuple:
    """One dispatch of the round kernel on ``fs``: the 13-tuple of
    :func:`fused_rounds`, or with ``out`` its :class:`KernelOut`.
    ``rounds_fn`` (FusedFrontier, ``out=`` -> the same) swaps in another
    round kernel: the exact-cover kernel (``ops/cuda_cover.py``) shares
    harvest, purge and steal this way; ``None`` dispatches the Sudoku
    kernel on ``geom`` through ``fused_rounds``, looked up in this module
    at call time."""
    kw = {} if out is None else {"out": out}
    if rounds_fn is not None:
        return rounds_fn(fs, **kw)
    return fused_rounds(
        fs.top, fs.stack, fs.has_top, fs.base, fs.count, geom,
        rules=config.rules, branch_rule=config.branch, max_sweeps=config.max_sweeps,
        k_steps=config.fused_steps, tile=min(128, fs.has_top.shape[0]),
        count_mode=config.count_all, sweep_unroll=config.fused_sweep_unroll, **kw,
    )


def _fused_bookkeeping(fs: FusedFrontier, out: tuple, config) -> FusedFrontier:
    """The job bookkeeping after one dispatch whose 13-tuple is ``out``:
    harvest the solutions, purge the solved jobs' lanes, steal, count.
    Device ops only, no host read, so that a CUDA graph can capture it."""
    n_jobs = fs.solved.shape[0]
    n_lanes = fs.has_top.shape[0]
    dev = fs.has_top.device
    job_safe = torch.clamp(fs.job, 0, n_jobs - 1).long()
    (top, stack, has_top, base, count, lane_solved, lane_sol, lane_over, nodes_d,
     sols_d, liv_d, sweeps_t, steps_m) = out

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


def _fused_round(fs: FusedFrontier, geom: Geometry | None, config, rounds_fn=None) -> FusedFrontier:
    """One kernel dispatch (``fused_steps`` rounds) + the job bookkeeping,
    eagerly (``rounds_fn``: see :func:`_round_kernel`)."""
    return _fused_bookkeeping(fs, _round_kernel(fs, geom, config, rounds_fn), config)


def _step_limit(limit, max_steps: int):
    """The one bound on ``steps`` that both of :func:`_run_fused`'s limits
    make: ``steps < min(limit, max_steps)``, on the device for a tensor
    ``limit`` (no host read)."""
    if isinstance(limit, torch.Tensor):
        return torch.clamp(limit, max=max_steps)
    return min(int(limit), max_steps)


def _fused_go(fs: FusedFrontier, limit) -> torch.Tensor:
    """The loop condition of :func:`_run_fused`, a 0-d bool tensor: a lane
    is live and ``steps`` is under ``limit`` (a :func:`_step_limit`)."""
    return _fused_live(fs).any() & (fs.steps < limit)


class _RoundGraph:
    """One dispatch's post-processing, bookkeeping and the next loop
    condition (:func:`_kernel_outputs`, :func:`_fused_bookkeeping`,
    :func:`_fused_go`), captured as a CUDA graph over static buffers:
    ``state``, the frontier between dispatches (the round kernel reads its
    lanes there), ``kout``, the kernel's own outputs (a :class:`KernelOut`,
    which the kernel writes each dispatch), ``limit`` and ``go``.  Each
    replay writes the next frontier into ``state`` and the condition into
    ``go``.  The round kernel stays outside the graph: it is launched by a
    Python call each dispatch.

    Captured on the first :meth:`dispatch_round`, after a warm-up run of
    the chain whose results are dropped, on a side stream, with
    ``capture_error_mode="thread_local"`` (other threads may copy and
    launch on the card meanwhile).  A capture that fails raises
    ``KernelError``."""

    graph = True

    def __init__(self, fs: FusedFrontier):
        dev = fs.has_top.device
        self.state = FusedFrontier(*(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in fs))
        self.limit = torch.zeros((), dtype=torch.int64, device=dev)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self.kout: KernelOut | None = None
        self.replay = None
        self.stream = None  # where the last call's reads of ``state`` were enqueued

    def load(self, fs: FusedFrontier, limit) -> None:
        """Start a call: the caller's frontier and limit into the buffers."""
        stream = torch.cuda.current_stream(self.go.device)
        if self.stream is not None and self.stream != stream:
            stream.wait_stream(self.stream)
        self.stream = stream
        torch._foreach_copy_(list(self.state), list(fs))
        self.limit.fill_(limit)

    def dispatch_round(self, geom: Geometry | None, config, rounds_fn) -> None:
        """One dispatch: the round kernel on the buffers by a Python call
        (:func:`_round_kernel`), writing into ``kout``, then the replay."""
        if self.replay is None:
            self.kout = _round_kernel(self.state, geom, config, rounds_fn,
                                      out=_out_buffers(self.state.top))
            self.replay = self._capture(config)
        else:
            _round_kernel(self.state, geom, config, rounds_fn, out=self.kout[:3])
        self.replay()

    def unload(self, stack: torch.Tensor) -> FusedFrontier:
        """End a call: fresh tensors of the frontier, which later calls do
        not write, its stack copied into the caller's ``stack``."""
        stack.copy_(self.state.stack)
        return FusedFrontier(*(stack if t is self.state.stack else t.clone() for t in self.state))

    def _chain(self, config) -> tuple:
        k = self.kout
        out = _kernel_outputs(k.top, self.state.stack, self.state.base, k.sol, k.lane_out,
                              k.tile, k.words)
        new = _fused_bookkeeping(self.state, out, config)
        return new, _fused_go(new, self.limit)

    def _write(self, new: FusedFrontier, go: torch.Tensor) -> None:
        pairs = [(s, n) for s, n in zip(self.state, new) if n is not s]
        torch._foreach_copy_([s for s, _ in pairs] + [self.go], [n for _, n in pairs] + [go])

    def _capture(self, config):
        """Warm up and capture the chain; returns the graph's replay."""
        dev = self.go.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                self._chain(config)
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                self._write(*self._chain(config))
        except RuntimeError as e:
            raise cuda_build.KernelError(f"capturing the fused loop's bookkeeping failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph.replay


class _EagerRounds:
    """:class:`_RoundGraph`'s interface over the caller's frontier itself,
    each dispatch an eager :func:`_fused_round`: the CPU's, where there are
    no graphs."""

    graph = False

    def load(self, fs: FusedFrontier, limit) -> None:
        self.state, self.limit = fs, limit

    def dispatch_round(self, geom: Geometry | None, config, rounds_fn) -> None:
        self.state = _fused_round(self.state, geom, config, rounds_fn)
        self.go = _fused_go(self.state, self.limit)

    def unload(self, stack: torch.Tensor) -> FusedFrontier:
        return self.state


class _GraphCache:
    """The captured chains of the process, by key: at most ``size`` idle
    ones are kept, the least recently used dropped first.  A claimed entry
    is its caller's alone until the claim ends (a second caller of the same
    key builds another), and an entry whose claim raised is dropped."""

    def __init__(self, size: int):
        self.size = size
        self.built = 0  # entries built, each one capture
        self._lock = lockdep.named_lock("ops.fused_graphs")  # lockck: name(ops.fused_graphs)
        self._slots: list = []  # [key, entry, claimed], least recently used first

    def __len__(self) -> int:
        return len(self._slots)

    @contextlib.contextmanager
    def claim(self, key, build):
        """Yield an idle entry of ``key``, or a new one from ``build()``."""
        with self._lock:
            slot = next((s for s in self._slots if s[0] == key and not s[2]), None)
            if slot is not None:
                self._slots.remove(slot)
                slot[2] = True
                self._slots.append(slot)
        if slot is None:
            slot = [key, build(), True]
            with self._lock:
                self._slots.append(slot)
                self.built += 1
        ok = False
        try:
            yield slot[1]
            ok = True
        finally:
            with self._lock:
                slot[2] = False
                if not ok:
                    self._slots.remove(slot)
                idle = [s for s in self._slots if not s[2]]
                for s in idle[: max(0, len(self._slots) - self.size)]:
                    self._slots.remove(s)


# Frontier shapes a process keeps captured.  A bulk pass uses three (the first
# pass and two rungs).  A serving node uses one a geometry for its resident
# flight and one for its megastep, and its static flights one a power-of-two
# job bucket, nine a geometry at max_batch 256: 22 for 9x9 and 16x16 together.
# An entry holds about twice its frontier (the frontier's and the kernel's
# outputs' buffers) and the graph's own pool.
_GRAPHS = _GraphCache(32)


def _graph_key(fs: FusedFrontier, config, rounds_fn) -> tuple:
    """Everything the captured chain reads: the device, the round kernel's
    family, ``count_all``, ``steal``, ``steal_gang``, and every field's
    shape (lanes, jobs, stack slots, the board) and dtype."""
    family = "K2" if rounds_fn is None else f"{rounds_fn.__module__}.{rounds_fn.__qualname__}"
    return (str(fs.has_top.device), family, bool(config.count_all), bool(config.steal),
            int(config.steal_gang), tuple((tuple(t.shape), t.dtype) for t in fs))


def _replays(fs: FusedFrontier) -> bool:
    """Whether :func:`_run_fused` replays its bookkeeping from a graph:
    on CUDA tensors."""
    return fs.has_top.device.type == "cuda"


def _run_fused(fs: FusedFrontier, geom: Geometry | None, config, limit,
               rounds_fn=None) -> FusedFrontier:
    """Dispatch fused rounds until nothing is live or ``steps`` reaches
    ``limit`` or ``config.max_steps`` (overshooting by up to
    ``fused_steps - 1``, as in JAX).  ``limit`` is a host int or a 0-d
    tensor on the frontier's device; both limits are compared on the
    device.  One host sync per dispatch reads the loop condition, the
    first before the first dispatch.  ``rounds_fn`` swaps the round
    kernel (see :func:`_round_kernel`).

    Each dispatch launches the round kernel by a Python call, then does
    the bookkeeping.  On CUDA tensors that is a replay (:class:`_RoundGraph`,
    one a key of :func:`_graph_key`, kept in ``_GRAPHS``): the call copies
    ``fs`` into the graph's buffers first and returns fresh tensors, with
    ``fs.stack`` updated in place.  On the CPU the same bookkeeping runs
    eagerly (:class:`_EagerRounds`), and a call that dispatches nothing
    returns ``fs`` itself on either.

    Under an open call-scoped recording (``obs.trace.current()``), each
    condition read is a ``fused.sync`` span and each dispatch's enqueue,
    from the read's return to the end of its bookkeeping, a
    ``fused.dispatch`` span; the spans tile the loop.  A dispatch whose
    bookkeeping was a replay counts one ``fused.graph``.  With none,
    ``trace.OFF`` reads no clock and records nothing."""
    rec = trace.current() or trace.OFF
    t = rec.now()
    limit = _step_limit(limit, config.max_steps)
    go = bool(_fused_go(fs, limit))
    t = rec.span("fused.sync", "fetch.loop", t)
    if not go:
        return fs
    if _replays(fs):
        rounds = _GRAPHS.claim(_graph_key(fs, config, rounds_fn), lambda: _RoundGraph(fs))
    else:
        rounds = contextlib.nullcontext(_EagerRounds())
    with rounds as g:
        g.load(fs, limit)
        while go:
            g.dispatch_round(geom, config, rounds_fn)
            if g.graph:
                rec.count("fused.graph")
            t = rec.span("fused.dispatch", "fused.dispatch", t)
            go = bool(g.go)
            t = rec.span("fused.sync", "fetch.loop", t)
        return g.unload(fs.stack)


def loop_counts(counts, dispatches: str, since=None) -> dict:
    """Round-kernel dispatches, host syncs and graph rounds among a
    recording's ``counts`` by name (less those of ``since``, an earlier
    copy): its ``fused.dispatch`` spans under the key ``dispatches``
    (``"k2_dispatches"``, ``"k3_dispatches"``), its ``*.sync`` spans as
    ``host_syncs`` and its ``fused.graph`` events as ``graph_rounds``."""
    since = since or {}
    n = {name: c - since.get(name, 0) for name, c in counts.items()}
    return {
        dispatches: n.get("fused.dispatch", 0),
        "host_syncs": sum(c for name, c in n.items() if name.endswith(".sync")),
        "graph_rounds": n.get("fused.graph", 0),
    }


def _advance_fused(state, step_limit, geom: Geometry, config):
    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    return fused_to_frontier(_run_fused(frontier_to_fused(state), geom, config, step_limit))


def advance_frontier_fused(state, step_limit, geom: Geometry, config):
    """Fused twin of ``utils.checkpoint.advance_frontier`` (lane-first
    ``Frontier`` in and out; its stack is updated in place)."""
    return _advance_fused(state, step_limit, geom, config)


def advance_frontier_fused_status(state, steps_delta, geom: Geometry, config):
    """Fused twin of ``utils.checkpoint.advance_frontier_status``: advance
    by at most ``steps_delta`` more rounds; returns ``(state, status)``.
    The limit is formed on the device (``state.steps + steps_delta``), so
    the host does not read the steps for it; the loop condition is still
    read before the first dispatch (:func:`_run_fused`), so this chunk is
    not enqueued before the previous one has finished (the device-side
    loop of ROADMAP A8 removes that read).  ``status`` is a fresh tensor
    that later dispatches never write."""
    new = _advance_fused(state, state.steps + steps_delta, geom, config)
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
