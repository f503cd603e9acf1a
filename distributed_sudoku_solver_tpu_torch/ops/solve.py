"""Single-device batched solve: the library entry points.

Port of the JAX package's ``ops/solve.py``.  Each job resolves to solved,
proven unsatisfiable, or unknown (step budget hit / stack overflow).
Entry points take ``device=None``, meaning CUDA, and raise when CUDA is
absent unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.models.sudoku import SudokuCSP
from distributed_sudoku_solver_tpu_torch.obs import trace as trace_mod
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
    # syncck: allow(caller input coercion: not a tensor, so host data)
    a = np.asarray(x)
    if a.dtype == np.uint32 and dtype == torch.int32:
        a = a.view(np.int32)  # bit patterns (e.g. the JAX package's states)
    return torch.as_tensor(a, dtype=dtype, device=device)


def solve_csp(
    states0, problem: CSProblem, config: SolverConfig = SolverConfig(), device=None,
    trace: Optional[dict] = None,
) -> SolveResult:
    """Solve root states [J, h, w] of a CSP; the solution is the raw solved state.

    ``step_impl='fused'`` serves the exact-cover family through its round
    kernel (``ops/cuda_cover.py``); Sudoku batches take it through
    :func:`solve_batch`, and any other family raises.

    Each call with ``trace`` (a dict), or under an installed ``obs.trace``
    recorder, opens one call-scoped recording (``obs.trace.recording``),
    as ``ops/bulk.solve_bulk`` does: the fused loop's ``fused.dispatch`` /
    ``fused.sync`` spans, and ``cover.solve`` around the call.  Its
    attributes: ``k3_dispatches``, ``host_syncs`` and ``graph_rounds``
    (``ops/cuda_step.loop_counts``; no dispatch on the composite path) and
    ``lanes``; with ``trace`` also what only the device holds, read in one
    fetch after the last dispatch: ``steps``, ``live_lane_rounds`` (the
    frontier's ``lane_rounds`` summed), ``nodes``, ``steals`` and
    ``solutions`` (``sol_count`` summed).  With ``trace`` the call writes
    the same keys into it, with ``trace_id``, ``spans`` and ``solve_s``
    (the ``cover.solve`` span's duration).  With neither, nothing is
    recorded and nothing more is read from the device."""
    from distributed_sudoku_solver_tpu_torch.ops.cuda_step import loop_counts

    dev = resolve_device(device)
    states0 = _as_tensor(states0, dev)
    with trace_mod.recording(keep=trace is not None) as rec:
        t0 = rec.now()
        state = _csp_frontier(states0, problem, config)
        res = finalize_frontier(state)
        attrs = {**loop_counts(rec.counts, "k3_dispatches"), "lanes": state.has_top.shape[0]}
        if trace is not None:
            attrs.update(_device_counts(state, res))
        t1 = rec.span("cover.solve", "cover.solve", t0, **attrs)
    if trace is not None:
        trace.update(attrs)
        trace["trace_id"] = rec.trace
        trace["spans"] = list(rec.spans)
        trace["solve_s"] = t1 - t0
    return res


def _csp_frontier(states0: torch.Tensor, problem: CSProblem, config: SolverConfig) -> Frontier:
    """:func:`solve_csp`'s search: the final frontier."""
    if config.step_impl == "fused":
        from distributed_sudoku_solver_tpu_torch.models.cover import ExactCoverCSP

        if isinstance(problem, ExactCoverCSP):
            from distributed_sudoku_solver_tpu_torch.ops.cuda_cover import cover_fused_frontier

            return cover_fused_frontier(states0, problem, config)
        # No fused kernel for other families; a silent composite fallback
        # would mislabel what ran.
        raise ValueError(
            "step_impl='fused' supports the Sudoku and exact-cover families only; "
            f"got a generic {type(problem).__name__}"
        )
    return run_frontier(init_frontier(states0, config), problem, config)


def _device_counts(state: Frontier, res: SolveResult) -> dict:
    """The ``cover.solve`` attributes that only the device holds, in one fetch."""
    keys = ("steps", "live_lane_rounds", "nodes", "steals", "solutions")
    values = torch.stack([
        res.steps.to(torch.int64), state.lane_rounds.sum(dtype=torch.int64),
        res.nodes.sum(dtype=torch.int64), res.steals.to(torch.int64),
        res.sol_count.sum(dtype=torch.int64),
    ])
    # syncck: allow(trace-only read: one fetch after the loop, for a kept recording only)
    return dict(zip(keys, values.tolist()))


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
    # syncck: allow(caller input: a host grid, not a tensor)
    res = solve_batch(np.asarray(grid)[None], geom, config, device=device)
    solved = bool(res.solved[0])
    # syncck: allow(the one board's answer, fetched once after its solve)
    sol = res.solution[0].cpu().numpy() if solved else None
    return sol, res
