"""The fused loop's job bookkeeping as a hand-written CUDA kernel, and its plain version.

Between two round-kernel dispatches (K2 or K3) the fused loop harvests the
first solutions, purges the solved jobs' lanes, steals, counts, and forms
the next loop condition.  A round function given ``out=`` writes its own
outputs into the loop's buffers and returns them as a :class:`KernelOut`;
:func:`_kernel_outputs` makes the 13-tuple of ``fused_rounds`` from them.

:func:`_fused_bookkeeping` and :func:`_fused_go` are the plain bookkeeping
and loop condition: functional, on any device, over the 13-tuple.
:func:`bookkeep_cuda` does the same in place, in three launches of
``csrc/bookkeep.cu``: it reads the round's :class:`KernelOut` and writes the
next frontier into ``state`` (every field but ``top``) and into
``kout.top``, which becomes the frontier's top, and the condition into
``go``.  Nothing is read on the host, so the fused loop
(``ops/cuda_step._run_fused``) captures it in a CUDA graph.
:func:`bookkeep_plain` writes the plain chain's results into the same
buffers: the loop's bookkeeping on the CPU, and the kernel's reference.
``bookkeep_cuda.launches`` counts the kernel's runs on the card: its calls
outside a graph capture, and each replay of the fused loop's graph (counted
there); a capture runs nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from distributed_sudoku_solver_tpu_torch.ops import cuda_build
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    _scatter_add,
    _scatter_min,
    _set_rows,
    _steal,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# ``csrc/bookkeep.cu``'s lanes a block and scratch scalars (``BLOCK``,
# ``N_SCALARS``); :func:`work_words` restates its layout.
BLOCK = 256
N_SCALARS = 5
NO_LANE = 2**31 - 1

_BOOL_FIELDS = ("has_top", "solved", "overflowed")
_SCALAR_FIELDS = ("steps", "sweeps", "expansions", "steals")


class KernelOut(NamedTuple):
    """A round's own outputs, in the buffers a caller passed as ``out``:
    the lanes' tops before the tile clear, their first solutions and the
    eight rows of ``lane_out``; ``tile`` and ``words`` (of each lane's
    flattened board, the leading ones the tile clear zeroes) are what
    :func:`_kernel_outputs` takes to make the 13-tuple of them."""

    top: torch.Tensor
    sol: torch.Tensor
    lane_out: torch.Tensor
    tile: int
    words: int


def _tile_clear(top: torch.Tensor, live_rounds: torch.Tensor, tile: int,
                words: int) -> torch.Tensor:
    """Clear the first ``words`` words of the flattened top of each lane
    that was dead in a round its ``tile``-lane tile still ran (fewer live
    rounds than the tile's busiest lane)."""
    lanes = top.shape[0]
    if lanes == 0:
        return top
    t = min(tile, lanes)
    if lanes % t:
        raise ValueError(f"lanes {lanes} not a multiple of tile {t}")
    per_tile = live_rounds.reshape(-1, t)
    dead = (per_tile < per_tile.amax(1, keepdim=True)).reshape(-1, 1)
    flat = top.reshape(lanes, -1)
    return torch.cat([flat[:, :words].masked_fill(dead, 0), flat[:, words:]], 1).reshape(top.shape)


def _kernel_outputs(top_out, stack, base, sol, lane_out, tile: int, words: int):
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


def _fused_live(fs: Frontier) -> torch.Tensor:
    n_jobs = fs.solved.shape[0]
    job_safe = torch.clamp(fs.job, 0, n_jobs - 1).long()
    return fs.has_top & (fs.job >= 0) & ~fs.solved[job_safe]


def _fused_bookkeeping(fs: Frontier, out: tuple, config) -> Frontier:
    """The job bookkeeping after one dispatch whose 13-tuple is ``out``:
    harvest the solutions, purge the solved jobs' lanes, steal, count.
    Device ops only, no host read."""
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

    return fs._replace(
        top=top, stack=stack, has_top=has_top, base=base, count=count, job=job,
        solved=solved, solution=solution, overflowed=overflowed, nodes=nodes,
        sol_count=sol_count, steps=fs.steps + steps_m, sweeps=fs.sweeps + sweeps_t,
        expansions=fs.expansions + nodes_d.sum(dtype=torch.int32),
        steals=fs.steals + n_steals, lane_rounds=fs.lane_rounds + liv_d,
    )


def _fused_go(fs: Frontier, limit) -> torch.Tensor:
    """The fused loop's condition, a 0-d bool tensor: a lane is live and
    ``steps`` is under ``limit`` (``ops/cuda_step._step_limit``)."""
    return _fused_live(fs).any() & (fs.steps < limit)


# -- the kernel ------------------------------------------------------------------


def work_words(lanes: int, jobs: int) -> int:
    """int32 words of the kernel's scratch: four per-job accumulators, the
    scalars, and per block of ``BLOCK`` lanes two counts, two prefixes and
    the warps' two ballots."""
    nb = -(-lanes // BLOCK)
    return 4 * jobs + N_SCALARS + 4 * nb + 2 + 2 * nb * (BLOCK // 32)


def new_work(lanes: int, jobs: int, device) -> torch.Tensor:
    """The scratch as the kernel expects it before its first call: each
    job's first-solution lane ``NO_LANE``, every other word 0.  Each call
    leaves the per-job accumulators and the scalars (the first ``4 * jobs +
    N_SCALARS`` words) so again; the per-block counts, prefixes and ballots
    after them are written anew before each read."""
    work = torch.zeros(work_words(lanes, jobs), dtype=torch.int32, device=device)
    work[:jobs] = NO_LANE
    return work


def _check(state: Frontier, kout: KernelOut, limit, go, work, config) -> tuple:
    """Raise on what the kernel does not take; returns ``(lanes, jobs,
    slots, words, clear_words, tile)``."""
    lanes, jobs = state.has_top.shape[0], state.solved.shape[0]
    board = tuple(state.top.shape[1:])
    words = math.prod(board)
    if lanes < 1 or jobs < 1 or words < 1:
        raise ValueError(f"bookkeeping needs lanes, jobs and board words; got {lanes}, {jobs}, "
                         f"{words}")
    want = {name: (lanes,) for name in ("has_top", "base", "count", "job", "lane_rounds")}
    want.update({name: (jobs,) for name in ("solved", "overflowed", "nodes", "sol_count")})
    want.update({name: () for name in _SCALAR_FIELDS})
    want.update(top=(lanes, *board), solution=(jobs, *board))
    tensors = {name: getattr(state, name) for name in want}
    tensors["stack"] = state.stack
    tensors.update(kernel_top=kout.top, lane_sol=kout.sol, lane_out=kout.lane_out,
                   limit=limit, go=go, work=work)
    want.update(kernel_top=(lanes, *board), lane_sol=(lanes, *board), lane_out=(8, lanes),
                limit=(), go=())
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(tensors[name].shape)}")
    if state.stack.ndim != 2 + len(board) or state.stack.shape[0] != lanes \
            or tuple(state.stack.shape[2:]) != board or state.stack.shape[1] < 1:
        raise ValueError(f"stack must be [{lanes}, S >= 1, {', '.join(map(str, board))}], "
                         f"got {list(state.stack.shape)}")
    if work.ndim != 1 or work.shape[0] < work_words(lanes, jobs):
        raise ValueError(f"work must hold {work_words(lanes, jobs)} words, got "
                         f"{list(work.shape)}")
    dtypes = {name: torch.int32 for name in tensors}
    dtypes.update({name: torch.bool for name in (*_BOOL_FIELDS, "go")}, limit=torch.int64)
    dev = state.has_top.device
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the frontier on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    tile = min(kout.tile, lanes)
    if tile < 1 or lanes % tile:
        raise ValueError(f"lanes {lanes} not a multiple of tile {tile}")
    if lanes > BLOCK and BLOCK % tile:
        raise ValueError(f"tile {tile} does not divide a block of {BLOCK} lanes")
    clear = kout.words
    if not 0 <= clear <= words:
        raise ValueError(f"the tile clear's words {clear} outside 0..{words}")
    gang = int(config.steal_gang) if config.steal else 0
    if gang < 0 or (gang > 0 and lanes % gang):
        raise ValueError(f"steal_gang={gang} does not divide lanes={lanes}")
    return lanes, jobs, state.stack.shape[1], words, clear, tile


def _lib():
    lib = cuda_build.load("bookkeep")
    fn = lib.dsst_bookkeep
    fn.argtypes = [_P] * 21 + [_LL] + [_I] * 9 + [_P]
    fn.restype = _I
    lib.dsst_bookkeep_prepare.restype = _I
    return lib


def prepare() -> None:
    """Load the library and its three kernels now (before a graph capture,
    which lazy module loading must not run into)."""
    cuda_build.check(_lib().dsst_bookkeep_prepare(), "dsst_bookkeep_prepare")


def bookkeep_cuda(state: Frontier, kout: KernelOut, limit: torch.Tensor, go: torch.Tensor,
                  work: torch.Tensor, config) -> None:
    """Launch the bookkeeping on CUDA tensors (no host sync), in place:
    ``state`` (not its ``top``), ``kout.top``, ``go`` and ``work``.
    ``config`` gives ``count_all``, ``steal`` and ``steal_gang``."""
    lanes, jobs, slots, words, clear, tile = _check(state, kout, limit, go, work, config)
    if state.has_top.device.type != "cuda":
        raise ValueError(f"bookkeep_cuda needs CUDA tensors; the frontier is on "
                         f"{state.has_top.device}")
    s = state
    ptrs = (s.has_top, s.base, s.count, s.job, s.solved, s.solution, s.overflowed, s.nodes,
            s.sol_count, s.steps, s.sweeps, s.expansions, s.steals, s.lane_rounds, s.stack,
            kout.top, kout.sol, kout.lane_out, limit, go, work)
    err = _lib().dsst_bookkeep(
        *(t.data_ptr() for t in ptrs), work.shape[0], lanes, jobs, slots, words, clear, tile,
        int(bool(config.count_all)), int(bool(config.steal)),
        int(config.steal_gang) if config.steal else 0,
        torch.cuda.current_stream(s.has_top.device).cuda_stream)
    cuda_build.check(err, "dsst_bookkeep")
    if not torch.cuda.is_current_stream_capturing():
        bookkeep_cuda.launches += 1


bookkeep_cuda.launches = 0


def bookkeep_plain(state: Frontier, kout: KernelOut, limit, go: torch.Tensor, work,
                   config) -> None:
    """The plain version, on any device: the plain chain, its results
    copied into the buffers :func:`bookkeep_cuda` writes (``work`` is not
    read)."""
    out = _kernel_outputs(kout.top, state.stack, state.base, kout.sol, kout.lane_out, kout.tile,
                          kout.words)
    new = _fused_bookkeeping(state, out, config)
    go.copy_(_fused_go(new, limit))
    for buf, val in zip(state._replace(top=kout.top), new):
        if val is not buf:
            buf.copy_(val)
