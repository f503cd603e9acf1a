"""K3: whole exact-cover rounds as a hand-written CUDA kernel, its plain version, and its fused-round driver.

Port of the JAX package's ``ops/pallas_cover.py``.  :func:`cover_fused_rounds`
advances every lane up to ``k_steps`` cover rounds (propagate to the
fixpoint, classify, capture the first solution, branch on the MRV column,
push/pop on the lane's circular stack, overflow) and returns the 13-tuple
of ``ops/cuda_step.fused_rounds``, so the fused driver (harvest, purge,
steal between dispatches) serves both kernels through its ``rounds_fn``
seam.

Layout: lane-first, ``top`` ``int32[L, 1, D]`` and ``stack``
``int32[L, S, 1, D]`` (uint32 patterns, the packed avail/covered words of
``models/cover.py``); the JAX kernel's ``[1, D, L]`` / ``[S, 1, D, L]``
boards-last forms are transposed by the tests.  ``stack`` is updated in
place and returned.

Semantics against the TPU kernel's 128-lane tiles: lanes converge on their
own (as in K2).  The TPU kernel masks a dead lane's available-row words to
0 while its tile runs on but keeps its covered words, so such a lane's top
comes back as ``[0 x W_r, covered]``; the wrappers reproduce exactly that.
``sweeps_total`` is the sum over lanes of each lane's own sweeps (the TPU
summed per-tile sweeps): the one output left out of bit-equality with JAX.

:func:`cover_fused_rounds` takes the plain version
(:func:`cover_fused_rounds_plain`) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``cover_fused_rounds_cuda.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.cover import ExactCoverCSP
from distributed_sudoku_solver_tpu_torch.ops import cuda_build
from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
    _kernel_outputs,
    _plain_rounds,
    _run_fused,
    frontier_to_fused,
    fused_to_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.frontier import FUSED_STEPS_LINKED, init_frontier

_P = ctypes.c_void_p
_I = ctypes.c_int

# Launch rule of K3, from the H100's shared memory.  A block holds per warp
# (lane) W_r exchange words and, when they fit, the column masks and the
# row lists as 16-bit pairs.  A compiled shape keeps a lane's row words and
# column counts in registers; the run-time shape keeps them in a private
# block of W_r + 32 W_c words per lane, in shared memory when it fits, else
# in device memory ([L, W_r + 32 W_c] int32 scratch, a few 1/S of the
# stack's bytes).
SMEM_BYTES = 232_448  # the most dynamic shared memory one block may use
MAX_WARPS = 8  # warps (lanes) per block
STAGE_BYTES = 100 * 1024  # staged blocks stay small enough for two per SM
# The kernel's column keys (rank << cb) | col, cb the bits of a column
# index and rank at most n_rows, are uint32 below 0xFFFFFFFF (no key).
KEY_LIMIT = 2**32


class LaunchShape(NamedTuple):
    warps: int  # lanes per block
    stage: bool  # column masks and row lists staged in shared memory
    smem_bytes: int
    shared_private: bool  # a lane's row words and counts on chip (else in device memory)
    instantiation: tuple[int, int, int]  # cover_kernel<RW, CW, ST>; (0, 0, -1): run-time


def column_bits(n_primary: int) -> int:
    """cb: the bits of a primary column index (0 for a single column)."""
    return (n_primary - 1).bit_length()


def private_words(problem: ExactCoverCSP) -> int:
    """The run-time shape's private block per lane: row words, 32 W_c counts."""
    return problem.w_rows + 32 * problem.w_cols


def stage_bytes(problem: ExactCoverCSP) -> int:
    """The staged constants: column masks and the zero mask at an odd pitch,
    then 32 * W_r row lists of K 16-bit entries."""
    k = problem.row_list().shape[1]
    return 4 * ((problem.n_cols_full + 1) * (problem.w_rows | 1) + 32 * problem.w_rows * k // 2)


def launch_shape(problem: ExactCoverCSP) -> LaunchShape:
    """K3's block shape and instantiation for ``problem``; raises for an
    instance it cannot take (no full incidence, keys beyond uint32, a lane's
    row words larger than a block's shared memory)."""
    if problem.incidence is None:
        raise ValueError(
            f"the cover kernel needs the full incidence matrix of {problem.name!r}; "
            "rebuild the instance with models.cover.build_cover"
        )
    key_ceiling = (problem.n_rows + 1) << column_bits(problem.n_primary)
    if key_ceiling >= KEY_LIMIT:
        raise ValueError(
            f"the cover kernel cannot serve {problem.name!r}: its column keys reach "
            f"{key_ceiling} >= 2**32; use step_impl='xla'"
        )
    const_bytes = stage_bytes(problem)
    stageable = problem.n_cols_full < 0xFFFF  # 0xFFFF pads the 16-bit lists

    def shape(lane_bytes, shared, inst):
        warps = min(MAX_WARPS, SMEM_BYTES // lane_bytes)
        stage = stageable and warps * lane_bytes + const_bytes <= STAGE_BYTES
        return LaunchShape(warps, stage, warps * lane_bytes + (const_bytes if stage else 0),
                           shared, inst)

    exchange = 4 * problem.w_rows
    if exchange > SMEM_BYTES:
        raise ValueError(
            f"the cover kernel cannot serve {problem.name!r}: one lane's row words are "
            f"{exchange} bytes, over the {SMEM_BYTES} bytes of a block's shared memory; "
            "use step_impl='xla'"
        )
    compiled = shape(exchange, True, None)
    inst = cuda_build.cover_instantiation(problem.w_rows, problem.w_cols, compiled.stage)
    if inst != (0, 0, -1):
        return compiled._replace(instantiation=inst)
    shared = exchange + 4 * private_words(problem) <= SMEM_BYTES
    return shape(exchange + (4 * private_words(problem) if shared else 0), shared, inst)


def _check_round_inputs(top, stack, has_top, base, count, problem: ExactCoverCSP):
    d = problem.w_rows + problem.w_cols
    if top.ndim != 3 or tuple(top.shape[1:]) != (1, d):
        raise ValueError(f"top must be [L, 1, {d}], got {tuple(top.shape)}")
    lanes = top.shape[0]
    if stack.ndim != 4 or stack.shape[0] != lanes or tuple(stack.shape[2:]) != (1, d):
        raise ValueError(f"stack must be [{lanes}, S, 1, {d}], got {tuple(stack.shape)}")
    if stack.shape[1] < 1:
        raise ValueError("stack needs at least one slot")
    for name, v in (("has_top", has_top), ("base", base), ("count", count)):
        if tuple(v.shape) != (lanes,):
            raise ValueError(f"{name} must be [{lanes}], got {tuple(v.shape)}")
    for name, v in (("top", top), ("stack", stack)):
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {v.dtype}")


def cover_fused_rounds_plain(
    top, stack, has_top, base, count, problem: ExactCoverCSP, max_sweeps: int = 64,
    k_steps: int = 8, tile: int = 128, count_mode: bool = False,
):
    """Plain torch re-statement of the round kernel, on any device."""
    _check_round_inputs(top, stack, has_top, base, count, problem)
    return _plain_rounds(
        top, stack, has_top, base, count, lambda b: problem.propagate_per_lane(b, max_sweeps),
        problem.status, problem.branch, k_steps, tile, count_mode, words=problem.w_rows,
    )


STAGES = ("state load", "count", "forced and MRV search", "lowest row", "take",
          "classify and capture", "push and pop", "total")


def _lib(variant: str = ""):
    lib = cuda_build.load("cover", variant)
    fn = lib.dsst_cover_rounds
    fn.argtypes = [_P] * 11 + [_I] * 13 + [_P]
    fn.restype = _I
    return lib


def _launch(variant, top, stack, has_top, base, count, problem, max_sweeps, k_steps, tile,
            count_mode):
    _check_round_inputs(top, stack, has_top, base, count, problem)
    for name, v in (("top", top), ("stack", stack), ("has_top", has_top),
                    ("base", base), ("count", count)):
        if v.device.type != "cuda":
            raise ValueError(f"cover_fused_rounds_cuda needs CUDA tensors; {name} is on {v.device}")
    return _call(_lib(variant).dsst_cover_rounds, torch.cuda.current_stream(top.device).cuda_stream,
                 top, stack, has_top, base, count, problem, max_sweeps, k_steps, tile,
                 count_mode)


def _call(fn, stream, top, stack, has_top, base, count, problem, max_sweeps, k_steps, tile,
          count_mode):
    """Marshal the arguments of ``dsst_cover_rounds`` (csrc/cover.cu) from
    tensors on one device, call ``fn`` with them and build the 13-tuple."""
    if not (top.is_contiguous() and stack.is_contiguous()):
        raise ValueError("cover_fused_rounds_cuda needs contiguous top and stack")
    if not (0 <= k_steps < 2**31 and 0 <= max_sweeps < 2**31):
        raise ValueError("k_steps / max_sweeps out of int32 range")
    shape = launch_shape(problem)
    consts = problem._tensors(top.device)
    lanes, s = stack.shape[:2]
    dev = top.device
    has_i = has_top.to(torch.int32).contiguous()
    base_i = base.to(torch.int32).contiguous()
    count_i = count.to(torch.int32).contiguous()
    top_out = torch.empty_like(top)
    sol = torch.empty_like(top)
    lane_out = torch.empty((8, lanes), dtype=torch.int32, device=dev)
    scratch = None if shape.shared_private else torch.empty(
        (lanes, private_words(problem)), dtype=torch.int32, device=dev)
    row_list = consts["row_list"]
    err = fn(top.data_ptr(), stack.data_ptr(), has_i.data_ptr(), base_i.data_ptr(),
             count_i.data_ptr(), top_out.data_ptr(), sol.data_ptr(), lane_out.data_ptr(),
             consts["col_rows_full"].data_ptr(), row_list.data_ptr(),
             None if scratch is None else scratch.data_ptr(), lanes, s, problem.w_rows,
             problem.w_cols, problem.n_primary, problem.n_cols_full, row_list.shape[1],
             max_sweeps, k_steps, int(count_mode), shape.warps, int(shape.stage),
             shape.smem_bytes, stream)
    cuda_build.check(err, "dsst_cover_rounds")
    return _kernel_outputs(top_out, stack, base_i, sol, lane_out, tile, words=problem.w_rows)


def cover_fused_rounds_cuda(
    top, stack, has_top, base, count, problem: ExactCoverCSP, max_sweeps: int = 64,
    k_steps: int = 8, tile: int = 128, count_mode: bool = False,
):
    """Launch K3 on CUDA tensors (no host sync); same returns as the plain version."""
    out = _launch("", top, stack, has_top, base, count, problem, max_sweeps, k_steps, tile,
                  count_mode)
    cover_fused_rounds_cuda.launches += 1
    return out


def cover_fused_rounds_stage_cycles(top, stack, has_top, base, count, problem: ExactCoverCSP,
                                    reps: int = 1, **kw) -> dict[str, int]:
    """K3's counter build (``-DDSST_STAGE_CLOCKS``) launched ``reps`` times
    on the same inputs (``stack`` is cloned for each, so every launch does
    the same work); returns the ``clock64()`` cycles that all warps spent
    in each stage of :data:`STAGES`, summed over warps and launches, and
    ``"longest warp"``, the largest total of one warp in one launch.
    Synchronizes.  Not a main-path launch: it does not count in
    ``cover_fused_rounds_cuda.launches``."""
    take = _lib("clocks").dsst_stage_cycles_take
    take.argtypes = [_P]
    take.restype = _I
    cycles = np.zeros(len(STAGES) + 1, dtype=np.uint64)
    torch.cuda.synchronize(top.device)
    cuda_build.check(take(cycles.ctypes.data), "dsst_stage_cycles_take")  # zero it
    for _ in range(reps):
        _launch("clocks", top, stack.clone(), has_top, base, count, problem, **{
            "max_sweeps": 64, "k_steps": 8, "tile": 128, "count_mode": False, **kw})
    torch.cuda.synchronize(top.device)
    cuda_build.check(take(cycles.ctypes.data), "dsst_stage_cycles_take")
    return {name: int(c) for name, c in zip((*STAGES, "longest warp"), cycles)}


cover_fused_rounds_cuda.launches = 0


def cover_fused_rounds(top, stack, has_top, base, count, problem: ExactCoverCSP, **kw):
    """Advance every lane up to ``k_steps`` cover rounds (see the module docstring).

    CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if top.device.type == "cpu":
        return cover_fused_rounds_plain(top, stack, has_top, base, count, problem, **kw)
    return cover_fused_rounds_cuda(top, stack, has_top, base, count, problem, **kw)


# -- driver -----------------------------------------------------------------------


def _rounds_fn(problem: ExactCoverCSP, config, lanes: int):
    def rounds(f):
        return cover_fused_rounds(
            f.top, f.stack, f.has_top, f.base, f.count, problem,
            max_sweeps=config.max_sweeps, k_steps=config.fused_steps,
            tile=min(128, lanes), count_mode=config.count_all,
        )

    return rounds


def cover_fused_lanes(n_lanes: int) -> int:
    """Round a cover lane count to the fused path's width: up to 128 lanes
    stay, beyond that a multiple of 128, as in the JAX package (the lane
    count decides where roots are seeded, so it is part of parity)."""
    if n_lanes <= 128:
        return n_lanes
    return -(-n_lanes // 128) * 128


def advance_cover_fused(state, step_limit, problem: ExactCoverCSP, config):
    """Cover twin of ``cuda_step.advance_frontier_fused``: advance a
    lane-first ``Frontier`` by fused dispatches until every job resolves or
    ``steps`` reaches ``step_limit`` (its stack is updated in place).  The
    cover kernel keeps the shallow ``FUSED_STEPS_LINKED`` default, as in
    the JAX package."""
    config = config.with_fused_steps(FUSED_STEPS_LINKED)
    limit = min(int(step_limit), config.max_steps)
    lanes = state.has_top.shape[0]
    fs = _run_fused(frontier_to_fused(state), None, config, limit,
                    rounds_fn=_rounds_fn(problem, config, lanes))
    return fused_to_frontier(fs)


def solve_cover_fused(states0: torch.Tensor, problem: ExactCoverCSP, config):
    """Fused-step cover solve: ``solve_csp``'s contract under fused rounds.
    Root states ``[J, 1, D]``; the solution is the raw solved state."""
    from distributed_sudoku_solver_tpu_torch.ops.solve import finalize_frontier

    config = config.with_fused_steps(FUSED_STEPS_LINKED)
    launch_shape(problem)  # an instance K3 cannot take raises before the first dispatch
    lanes = cover_fused_lanes(config.resolve_lanes(states0.shape[0]))
    config = dataclasses.replace(config, lanes=lanes)
    state = init_frontier(states0, config)
    fs = _run_fused(frontier_to_fused(state), None, config, config.max_steps,
                    rounds_fn=_rounds_fn(problem, config, lanes))
    return finalize_frontier(fused_to_frontier(fs))
