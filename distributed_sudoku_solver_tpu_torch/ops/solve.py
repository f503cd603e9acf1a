"""Single-device batched solve: the library entry points.

Port of the JAX package's ``ops/solve.py``.  Each job resolves to solved,
proven unsatisfiable, or unknown (step budget hit / stack overflow).
Entry points take ``device=None``, meaning CUDA, and raise when CUDA is
absent unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.ops.bitmask import decode_grid, encode_grid
from distributed_sudoku_solver_tpu_torch.ops.csp import CSProblem
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    SolverConfig,
    _scatter_max_bool,
    frontier_live,
    init_frontier,
    run_frontier,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raise if CUDA is absent and the CPU was not asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "torch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class SolveResult(NamedTuple):
    solution: torch.Tensor  # int32 grid per job (raw state for solve_csp)
    solved: torch.Tensor  # bool[J]
    unsat: torch.Tensor  # bool[J]: search space exhausted with no solution
    overflowed: torch.Tensor  # bool[J]: a subtree was dropped
    nodes: torch.Tensor  # int32[J] branch nodes expanded
    sol_count: torch.Tensor  # int32[J] solutions found
    steps: torch.Tensor  # int32 frontier rounds
    sweeps: torch.Tensor  # int32 total propagation sweeps
    expansions: torch.Tensor  # int32 total branch expansions
    steals: torch.Tensor  # int32 total lane-to-lane steals


def finalize_frontier(state: Frontier) -> SolveResult:
    """Frontier -> verdicts; the solution stays in raw problem-state form."""
    n_jobs = state.solved.shape[0]
    live = frontier_live(state)
    job_safe = torch.clamp(state.job, 0, n_jobs - 1)
    job_has_work = _scatter_max_bool(n_jobs, job_safe, live)
    unsat = ~state.solved & ~job_has_work & ~state.overflowed
    return SolveResult(
        solution=state.solution,
        solved=state.solved,
        unsat=unsat,
        overflowed=state.overflowed,
        nodes=state.nodes,
        sol_count=state.sol_count,
        steps=state.steps,
        sweeps=state.sweeps,
        expansions=state.expansions,
        steals=state.steals,
    )


def _decode_solution(res: SolveResult) -> SolveResult:
    """Sudoku entry points return int grids, not candidate masks."""
    has_sol = res.solved | (res.sol_count > 0)
    grid = decode_grid(res.solution)
    solution = torch.where(has_sol[:, None, None], grid, torch.zeros_like(grid))
    return res._replace(solution=solution)


def _finalize(state: Frontier) -> SolveResult:
    return _decode_solution(finalize_frontier(state))


def sudoku_csp(geom: Geometry, config: SolverConfig) -> SudokuCSP:
    """The Sudoku problem a (geom, config) pair denotes."""
    return SudokuCSP(
        geom=geom,
        branch_rule=config.branch,
        max_sweeps=config.max_sweeps,
        propagator=config.propagator,
        rules=config.rules,
    )


def _as_tensor(x, device: torch.device, dtype=torch.int32) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if a.dtype == np.uint32 and dtype == torch.int32:
        a = a.view(np.int32)  # bit patterns (e.g. the JAX package's states)
    return torch.as_tensor(a, dtype=dtype, device=device)


def solve_csp(
    states0, problem: CSProblem, config: SolverConfig = SolverConfig(), device=None
) -> SolveResult:
    """Solve root states [J, h, w] of a CSP; the solution is the raw solved state.

    ``step_impl='fused'`` serves the exact-cover family through its round
    kernel (``ops/cuda_cover.py``); Sudoku batches take it through
    :func:`solve_batch`, and any other family raises."""
    dev = resolve_device(device)
    states0 = _as_tensor(states0, dev)
    if config.step_impl == "fused":
        from distributed_sudoku_solver_tpu_torch.models.cover import ExactCoverCSP

        if isinstance(problem, ExactCoverCSP):
            from distributed_sudoku_solver_tpu_torch.ops.cuda_cover import solve_cover_fused

            return solve_cover_fused(states0, problem, config)
        # No fused kernel for other families; a silent composite fallback
        # would mislabel what ran.
        raise ValueError(
            "step_impl='fused' supports the Sudoku and exact-cover families only; "
            f"got a generic {type(problem).__name__}"
        )
    state = init_frontier(states0, config)
    return finalize_frontier(run_frontier(state, problem, config))


def solve_batch(
    grids, geom: Geometry, config: SolverConfig = SolverConfig(), device=None
) -> SolveResult:
    """Solve int grids [J, n, n] (0 = empty)."""
    dev = resolve_device(device)
    grids = _as_tensor(grids, dev)
    if config.step_impl == "fused":
        from distributed_sudoku_solver_tpu_torch.ops.cuda_step import solve_batch_fused

        return solve_batch_fused(grids, geom, config)
    state = init_frontier(encode_grid(grids, geom), config)
    state = run_frontier(state, sudoku_csp(geom, config), config)
    return _finalize(state)


def solve_batch_wire(
    packed,
    geom: Geometry,
    config: SolverConfig = SolverConfig(),
    fmt: str = "packed",
    device=None,
) -> torch.Tensor:
    """Wire-format solve: packed grids in, packed solution + verdicts out
    (``ops/wire.py``); the result stays on the device."""
    from distributed_sudoku_solver_tpu_torch.ops import wire

    dev = resolve_device(device)
    dtype = torch.uint8 if (fmt == "dense" or wire.uses_nibbles(geom)) else torch.int8
    packed = _as_tensor(packed, dev, dtype)
    if fmt == "dense":
        grids = wire.unpack_grids_dense_device(packed, geom)
    else:
        grids = wire.unpack_grids_device(packed, geom)
    res = solve_batch(grids, geom, config, device=dev)
    if fmt == "dense":
        return wire.pack_result_dense_device(
            res.solution, res.solved, res.unsat, res.nodes > 0, geom
        )
    return wire.pack_result_device(res.solution, res.solved, res.unsat, res.nodes > 0, geom)


def solve_one(grid, geom: Geometry, config: SolverConfig = SolverConfig(), device=None):
    """Solve a single board; returns (np solution | None, SolveResult)."""
    res = solve_batch(np.asarray(grid)[None], geom, config, device=device)
    solved = bool(res.solved[0])
    sol = res.solution[0].cpu().numpy() if solved else None
    return sol, res
