"""The fused loop's job bookkeeping as a hand-written CUDA kernel, and its plain version.

Between two round-kernel dispatches (K2 or K3) the fused loop harvests the
first solutions, purges the solved jobs' lanes, steals, counts, and forms
the next loop condition.  :func:`bookkeep_cuda` does all of it in place,
in three launches of ``csrc/bookkeep.cu``: it reads the round's
:class:`~.cuda_step.KernelOut` and writes the next frontier into ``state``
(every field but ``top``) and into ``kout.top``, which becomes the
frontier's top, and the condition into ``go``.  Nothing is read on the
host, so the fused loop's graph (``ops/cuda_step._RoundGraph``) captures it.

:func:`bookkeep_plain` is the plain version, on any device:
``_kernel_outputs``, ``_fused_bookkeeping`` and ``_fused_go`` of
``ops/cuda_step.py`` (the chain the CPU's eager loop runs) with the results
copied into the same buffers.  ``bookkeep_cuda.launches`` counts the
bookkeeping's runs on the card: its calls outside a graph capture, and each
replay of the fused loop's graph (counted there); a capture runs nothing and
counts nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import TYPE_CHECKING

import torch

from distributed_sudoku_solver_tpu_torch.ops import cuda_build

if TYPE_CHECKING:
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import FusedFrontier, KernelOut

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


def _check(state: FusedFrontier, kout: KernelOut, limit, go, work, config) -> tuple:
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
    clear = words if kout.words is None else kout.words
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


def bookkeep_cuda(state: FusedFrontier, kout: KernelOut, limit: torch.Tensor, go: torch.Tensor,
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


def bookkeep_plain(state: FusedFrontier, kout: KernelOut, limit, go: torch.Tensor, work,
                   config) -> None:
    """The plain version, on any device: the eager chain, its results
    copied into the buffers :func:`bookkeep_cuda` writes (``work`` is not
    read)."""
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
        _fused_bookkeeping,
        _fused_go,
        _kernel_outputs,
    )

    out = _kernel_outputs(kout.top, state.stack, state.base, kout.sol, kout.lane_out, kout.tile,
                          kout.words)
    new = _fused_bookkeeping(state, out, config)
    go.copy_(_fused_go(new, limit))
    for buf, val in zip(state._replace(top=kout.top), new):
        if val is not buf:
            buf.copy_(val)

