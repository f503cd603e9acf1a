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
raises.  ``fused_rounds_cuda.launches`` counts kernel launches.  Every
round function, K2's and K3's, plain or kernel, takes ``out=`` (three
buffers: tops, solutions, ``lane_out``): given it, the function writes
its own outputs there and returns a ``KernelOut``; without it, the
13-tuple (:func:`_round_outputs`).

The fused loop (:func:`_run_fused`) has one driver on every device
(:class:`_Rounds`): each dispatch calls the round function (K2's
:func:`_rounds_fn`, or K3's from ``ops/cuda_cover.py``) on the driver's
buffers, then runs the job bookkeeping (harvest, purge, steal, counters)
in place, ``ops/cuda_bookkeep.py``.  On CUDA the bookkeeping is a
hand-written kernel (``csrc/bookkeep.cu``) replayed from a captured CUDA
graph; on the CPU it is the plain version, called directly.  The loop
keeps :data:`LOOKAHEAD` dispatches enqueued while it reads a flag, so the
device does not wait for the host between dispatches; a dispatch enqueued
after the flag fell is an exact no-op.  :func:`_fused_round` is the
functional reference step.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.obs import lockdep, trace
from distributed_sudoku_solver_tpu_torch.ops import cuda_bookkeep, cuda_build, ordering
from distributed_sudoku_solver_tpu_torch.ops.bitmask import (
    is_single,
    lowest_bit,
    once_twice_reduce,
    or_reduce,
    popcount,
)
from distributed_sudoku_solver_tpu_torch.ops.cuda_bookkeep import (
    KernelOut,
    _fused_bookkeeping,
    _fused_go,
    _fused_live,
    _kernel_outputs,
)
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    FUSED_STEPS_DEVICE,
    Frontier,
    _scatter_max_bool,
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
                  k_steps: int, tile: int, count_mode: bool, words: int, out=None):
    """The round loop of the plain versions of K2 and K3.  The family gives
    ``propagate(tops) -> (tops, per-lane sweeps)``, ``status(tops) ->
    (solved, contradiction)`` and ``branch(tops) -> (guess, rest)``;
    ``words`` goes to the tile clear, ``out`` to :func:`_round_outputs`."""
    if out is not None:
        out = _out_buffers(top, out)
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
    return _round_outputs(top, stack, base, sol, lane_out, tile, words, out)


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


def _round_outputs(top, stack, base, sol, lane_out, tile: int, words: int, out):
    """A round's returns: the 13-tuple (:func:`_kernel_outputs`), or with
    ``out`` a :class:`KernelOut` of those buffers, which a kernel wrote
    and into which a plain version copies its outputs."""
    if out is None:
        return _kernel_outputs(top, stack, base, sol, lane_out, tile, words)
    for buf, val in zip(out, (top, sol, lane_out)):
        if buf is not val:
            buf.copy_(val)
    return KernelOut(*out, tile, words)


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
    tile: int = 128, count_mode: bool = False, sweep_unroll: int = 2, out=None,
):
    """Plain torch re-statement of the round kernel, on any device; ``out``
    as for :func:`fused_rounds_cuda`."""
    _check_round_inputs(top, stack, has_top, base, count, geom, rules, branch_rule)
    if ordering.is_head_rule(branch_rule):
        branch = lambda b: head_branch_full(b, geom, branch_rule)  # noqa: E731
    else:
        branch = SudokuCSP(geom, branch_rule, max_sweeps, "xla", rules).branch
    return _plain_rounds(
        top, stack, has_top, base, count,
        lambda b: propagate_per_board(b, geom, max_sweeps, rules, unroll=sweep_unroll),
        lambda b: status_full(b, geom), branch, k_steps, tile, count_mode, geom.n * geom.n, out,
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
    return _round_outputs(top_out, stack, base_i, sol, lane_out, tile, geom.n * geom.n, out)


def fused_rounds_cuda(
    top, stack, has_top, base, count, geom: Geometry, rules: str = "extended",
    branch_rule: str = "minrem", max_sweeps: int = 64, k_steps: int = 8,
    tile: int = 128, count_mode: bool = False, sweep_unroll: int = 2, out=None,
):
    """Launch K2 on CUDA tensors (no host sync); same returns as the plain
    version.  With ``out`` (three buffers: tops, solutions, ``lane_out``)
    the kernel writes its own outputs there and the call returns them as a
    :class:`KernelOut`, for a caller that makes the 13-tuple later (the
    fused loop's bookkeeping)."""
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


def _rounds_fn(geom: Geometry, config, lanes: int):
    """K2's round function for the fused loop on ``lanes`` lanes: a
    frontier (and ``out=``) -> the returns of :func:`fused_rounds`, looked
    up in this module at each call (the benchmark's K2 replay patches it).
    It states the tile clear's ``words`` (the whole board) and its
    ``tile``, which the loop's graph bakes in."""

    def rounds(f, **kw):
        return fused_rounds(
            f.top, f.stack, f.has_top, f.base, f.count, geom,
            rules=config.rules, branch_rule=config.branch, max_sweeps=config.max_sweeps,
            k_steps=config.fused_steps, tile=rounds.tile, count_mode=config.count_all,
            sweep_unroll=config.fused_sweep_unroll, **kw,
        )

    rounds.words, rounds.tile = geom.n * geom.n, min(128, lanes)
    return rounds


def _fused_round(fs: Frontier, config, rounds_fn) -> Frontier:
    """One dispatch of ``rounds_fn`` (``fused_steps`` rounds) and the job
    bookkeeping, functionally: the fused loop's reference step."""
    return _fused_bookkeeping(fs, rounds_fn(fs), config)


def _step_limit(limit, max_steps: int):
    """The one bound on ``steps`` that both of :func:`_run_fused`'s limits
    make: ``steps < min(limit, max_steps)``, on the device for a tensor
    ``limit`` (no host read)."""
    if isinstance(limit, torch.Tensor):
        return torch.clamp(limit, max=max_steps)
    return min(int(limit), max_steps)


# Dispatches enqueued when the fused loop reads a loop flag: the one whose
# flag it reads and LOOKAHEAD - 1 behind it, so the host enqueues while the
# device runs.  Each call ends with LOOKAHEAD - 1 spare dispatches, enqueued
# after the flag fell, which change nothing.
LOOKAHEAD = 2


class _Rounds:
    """The fused loop's driver over static buffers: ``state``, the
    frontier between dispatches, the round function's own outputs (``sol``,
    ``lane_out`` and a top; ``kout`` is the :class:`KernelOut` it
    returned), ``limit``, ``go``, ``gate`` and the bookkeeping kernel's
    scratch ``work``.  Each dispatch calls the round function on
    ``state`` with ``gate`` as its ``has_top`` and with ``out=`` those
    buffers, then runs the bookkeeping in place, which writes the next
    frontier into ``state``, the loop condition into ``go`` and
    ``has_top & go`` into ``gate``, then copies ``go`` into a slot of the
    host ring ``flags``, which :meth:`flag` reads.

    ``go`` is true after :meth:`load`; the bookkeeping of a dispatch that
    finds it false changes nothing, and that dispatch's round function saw
    ``gate`` all zero, so no live lane, and wrote every top through
    unchanged.  So a dispatch enqueued after the flag fell (a spare)
    leaves the frontier as it was, bit for bit.

    The frontier's top and the round's output top are two buffers,
    ``tops``, that swap each dispatch: the round reads one and writes the
    other, which the bookkeeping then edits in place and ``state`` takes
    as its top, so no top is copied.

    The device decides two things.  On the CPU the bookkeeping is
    ``bookkeep_plain``, called directly.  On CUDA it is ``bookkeep_cuda``
    (``csrc/bookkeep.cu``, three launches), captured as two CUDA graphs,
    one each way round, on the first :meth:`dispatch_round` (the kernels
    loaded first), on a side stream, with ``capture_error_mode=
    "thread_local"`` (other threads may copy and launch on the card
    meanwhile); a capture that fails raises ``KernelError``.  Each replay
    counts one run in ``bookkeep_cuda.launches`` and one ``fused.graph``.
    The round function stays outside the graph: it is called from Python
    each dispatch.

    On CUDA each slot of ``flags`` (pinned) has an event recorded after
    its copy, so reading a flag waits for its dispatch alone, not for the
    ones enqueued behind it; on the CPU the copy is done when it returns."""

    def __init__(self, fs: Frontier):
        dev = fs.has_top.device
        lanes, jobs = fs.has_top.shape[0], fs.solved.shape[0]
        self.captured = dev.type != "cpu"
        self.state = Frontier(*(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in fs))
        self.tops = (self.state.top, torch.empty_like(self.state.top))
        self.sol = torch.empty_like(self.state.top)
        self.lane_out = torch.empty((8, lanes), dtype=torch.int32, device=dev)
        self.limit = torch.zeros((), dtype=torch.int64, device=dev)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self.gate = torch.zeros(lanes, dtype=torch.int32, device=dev)
        self.work = cuda_bookkeep.new_work(lanes, jobs, dev) if self.captured else None
        flags = torch.zeros(LOOKAHEAD, dtype=torch.bool, pin_memory=self.captured)
        self.flags = flags.unbind(0)
        self.events = [torch.cuda.Event() for _ in self.flags] if self.captured else None
        self.kout: KernelOut | None = None
        self.graphs = None  # by the index in ``tops`` of the frontier's top
        self.stream = None  # where the last call's reads of ``state`` were enqueued

    def load(self, fs: Frontier, limit) -> None:
        """Start a call whose loop condition the host read as true: the
        caller's frontier and limit into the buffers, ``go`` true and
        ``gate`` the frontier's ``has_top``."""
        if self.captured:
            stream = torch.cuda.current_stream(self.go.device)
            if self.stream is not None and self.stream != stream:
                stream.wait_stream(self.stream)
            self.stream = stream
        torch._foreach_copy_(list(self.state), list(fs))
        self.limit.fill_(limit)
        self.go.fill_(True)
        self.gate.copy_(fs.has_top)

    def dispatch_round(self, rounds_fn, config, rec, slot: int) -> None:
        """One dispatch: the round function on the buffers, writing into
        ``tops``, ``sol`` and ``lane_out``, then the bookkeeping, then
        ``go`` into ``flags[slot]``."""
        p = 0 if self.state.top is self.tops[0] else 1
        self.kout = rounds_fn(self.state._replace(has_top=self.gate),
                              out=(self.tops[1 - p], self.sol, self.lane_out))
        if self.captured:
            if self.graphs is None:
                self.graphs = self._capture(config)
            self.graphs[p].replay()
            cuda_bookkeep.bookkeep_cuda.launches += 1
            rec.count("fused.graph")
        else:
            self._bookkeep(p, config)
        self.state = self.state._replace(top=self.tops[1 - p])
        self.flags[slot].copy_(self.go, non_blocking=self.captured)
        if self.captured:  # on the stream of the copy: the frontier device's, not the current
            self.events[slot].record(self.stream)

    def flag(self, slot: int) -> bool:
        """The loop condition after the dispatch that last wrote
        ``flags[slot]``; on CUDA this waits for that dispatch only."""
        if self.captured:
            self.events[slot].synchronize()  # the loop's one host wait a dispatch
        return bool(self.flags[slot])  # a host tensor, its copy complete

    def unload(self, stack: torch.Tensor) -> Frontier:
        """End a call: fresh tensors of the frontier, which later calls do
        not write, its stack copied into the caller's ``stack``."""
        stack.copy_(self.state.stack)
        return Frontier(*(stack if t is self.state.stack else t.clone() for t in self.state))

    def _bookkeep(self, p: int, config) -> None:
        """The bookkeeping of a dispatch that read ``tops[p]``."""
        bookkeep = cuda_bookkeep.bookkeep_cuda if self.captured else cuda_bookkeep.bookkeep_plain
        bookkeep(self.state._replace(top=self.tops[p]), self.kout._replace(top=self.tops[1 - p]),
                 self.limit, self.go, self.work, config, self.gate)

    def _capture(self, config) -> tuple:
        """Capture the bookkeeping both ways round; returns the graphs."""
        dev = self.go.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graphs = []
        try:
            cuda_bookkeep.prepare()
            for p in (0, 1):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    self._bookkeep(p, config)
                graphs.append(graph)
        except RuntimeError as e:
            raise cuda_build.KernelError(f"capturing the fused loop's bookkeeping failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        return tuple(graphs)


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
# An entry holds its frontier, a second top, the round kernel's other outputs
# and the bookkeeping kernel's scratch; its two graphs allocate nothing.
_GRAPHS = _GraphCache(32)


def _graph_key(fs: Frontier, config, rounds_fn) -> tuple:
    """Everything the captured bookkeeping reads: the device, the tile
    clear's words and tile that ``rounds_fn`` states, ``count_all``,
    ``steal``, ``steal_gang``, and every field's shape (lanes, jobs, stack
    slots, the board) and dtype."""
    return (str(fs.has_top.device), int(rounds_fn.words), int(rounds_fn.tile),
            bool(config.count_all), bool(config.steal), int(config.steal_gang),
            tuple((tuple(t.shape), t.dtype) for t in fs))


def _run_fused(fs: Frontier, config, limit, rounds_fn) -> Frontier:
    """Dispatch ``rounds_fn`` (K2's :func:`_rounds_fn`, or K3's in
    ``ops/cuda_cover.py``) until nothing is live or ``steps`` reaches
    ``limit`` or ``config.max_steps`` (overshooting by up to
    ``fused_steps - 1``, as in JAX).  ``limit`` is a host int or a 0-d
    tensor on the frontier's device; both limits are compared on the
    device.  On CUDA the frontier's device is the current device for the
    loop (the caller's may be another card).  The host reads the loop
    condition once before the first dispatch and then once a dispatch,
    after enqueuing the next one (:data:`LOOKAHEAD`), so a call ends with a
    spare dispatch, enqueued after the flag fell, which changes nothing.

    Each dispatch calls the round function, then does the bookkeeping
    (:class:`_Rounds`).  The call copies ``fs`` into the driver's buffers
    first and returns fresh tensors, with ``fs.stack`` updated in place; a
    call that dispatches nothing returns ``fs`` itself.  On CUDA the
    driver, its captured graphs included, is kept in ``_GRAPHS``, one a key
    of :func:`_graph_key`; on the CPU each call builds its own.

    Under an open call-scoped recording (``obs.trace.current()``), each
    condition read is a ``fused.sync`` span and each dispatch's enqueue,
    spares included, a ``fused.dispatch`` span; the spans tile the loop.  A
    dispatch whose bookkeeping was a replay counts one ``fused.graph``, and
    each spare one ``fused.spare``, known on the host: every dispatch
    enqueued after the read that found the flag false.  With none,
    ``trace.OFF`` reads no clock and records nothing."""
    rec = trace.current() or trace.OFF
    t = rec.now()
    limit = _step_limit(limit, config.max_steps)
    go = bool(_fused_go(fs, limit))
    t = rec.span("fused.sync", "fetch.loop", t)
    if not go:
        return fs
    if fs.has_top.device.type == "cpu":
        card, driver = contextlib.nullcontext(), contextlib.nullcontext(_Rounds(fs))
    else:  # the kernel libraries launch on the current device: make it the frontier's
        card = torch.cuda.device(fs.has_top.device)
        driver = _GRAPHS.claim(_graph_key(fs, config, rounds_fn), lambda: _Rounds(fs))
    with card, driver as g:
        g.load(fs, limit)
        queued = read = 0
        while go:
            while queued < read + LOOKAHEAD:
                g.dispatch_round(rounds_fn, config, rec, queued % LOOKAHEAD)
                queued += 1
                t = rec.span("fused.dispatch", "fused.dispatch", t)
            go = g.flag(read % LOOKAHEAD)
            read += 1
            t = rec.span("fused.sync", "fetch.loop", t)
        for _ in range(queued - read):
            rec.count("fused.spare")
        return g.unload(fs.stack)


def loop_counts(counts, dispatches: str, since=None) -> dict:
    """Round-kernel dispatches, host syncs, graph rounds and spare
    dispatches among a recording's ``counts`` by name (less those of
    ``since``, an earlier copy): its ``fused.dispatch`` spans (spares
    included) under the key ``dispatches`` (``"k2_dispatches"``,
    ``"k3_dispatches"``), its ``*.sync`` spans as ``host_syncs``, its
    ``fused.graph`` events as ``graph_rounds`` and its ``fused.spare``
    events as ``spare_dispatches``."""
    since = since or {}
    n = {name: c - since.get(name, 0) for name, c in counts.items()}
    return {
        dispatches: n.get("fused.dispatch", 0),
        "host_syncs": sum(c for name, c in n.items() if name.endswith(".sync")),
        "graph_rounds": n.get("fused.graph", 0),
        "spare_dispatches": n.get("fused.spare", 0),
    }


def advance_frontier_fused(state, step_limit, geom: Geometry, config):
    """Fused twin of ``utils.checkpoint.advance_frontier`` (lane-first
    ``Frontier`` in and out; its stack is updated in place)."""
    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    return _run_fused(state, config, step_limit,
                      _rounds_fn(geom, config, state.has_top.shape[0]))


def advance_frontier_fused_status(state, steps_delta, geom: Geometry, config):
    """Fused twin of ``utils.checkpoint.advance_frontier_status``: advance
    by at most ``steps_delta`` more rounds; returns ``(state, status)``.
    The limit is formed on the device (``state.steps + steps_delta``), so
    the host does not read the steps for it; the loop condition is still
    read before the first dispatch (:func:`_run_fused`), so this chunk is
    not enqueued before the previous one has finished.  ``status`` is a
    fresh tensor that later dispatches never write."""
    new = advance_frontier_fused(state, state.steps + steps_delta, geom, config)
    return new, chunk_status(state.steps, state.lane_rounds, new)


def advance_megastep_fused(state, chunk_steps: int, max_chunks: int, geom: Geometry, config):
    """Fused twin of ``ops.frontier.advance_megastep``: one latency-mode
    flight of K2 dispatches in chunks of ``chunk_steps`` rounds, with the
    same flight-start status baselines and early exit; returns
    ``(state, status, chunks)``.  The host reads the loop condition once
    per dispatch and once per chunk (JAX: once per flight)."""
    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    rounds = _rounds_fn(geom, config, state.has_top.shape[0])
    return megastep_chunks(state, lambda f, limit: _run_fused(f, config, limit, rounds),
                           chunk_steps, max_chunks, config.max_steps)


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
    fs = _run_fused(state, config, config.max_steps, _rounds_fn(geom, config, lanes))

    job_safe = torch.clamp(fs.job, 0, n_jobs - 1)
    job_has_work = _scatter_max_bool(n_jobs, job_safe, _fused_live(fs))
    unsat = ~fs.solved & ~job_has_work & ~fs.overflowed
    res = SolveResult(
        solution=fs.solution, solved=fs.solved, unsat=unsat, overflowed=fs.overflowed,
        nodes=fs.nodes, sol_count=fs.sol_count, steps=fs.steps, sweeps=fs.sweeps,
        expansions=fs.expansions, steals=fs.steals,
    )
    return _decode_solution(res)
