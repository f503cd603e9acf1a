"""Stepped frontier advances: the frontier tensor is the resumable state.

The part of the JAX package's ``utils/checkpoint.py`` that the bulk rungs
use: start a frontier from grids and advance it in bounded-step chunks.
Saving and loading snapshots is not ported yet.  The advances update the
frontier's stack in place (the JAX versions donate the state): callers
rebind the returned state and drop the old one.
"""

from __future__ import annotations

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    SolverConfig,
    chunk_status,
    init_frontier,
    run_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import sudoku_csp


def start_frontier(grids: torch.Tensor, geom: Geometry, config: SolverConfig) -> Frontier:
    return init_frontier(encode_grid(grids.to(torch.int32), geom), config)


def advance_frontier(
    state: Frontier, step_limit, geom: Geometry, config: SolverConfig
) -> Frontier:
    """Run until every job resolves or ``state.steps`` reaches ``step_limit``."""
    return run_frontier(state, sudoku_csp(geom, config), config, step_limit=step_limit)


def advance_frontier_status(
    state: Frontier, steps_delta, geom: Geometry, config: SolverConfig
):
    """One chunk: advance by at most ``steps_delta`` more rounds; returns
    ``(new_state, packed status)`` (``ops.frontier.chunk_status``)."""
    new = run_frontier(
        state,
        sudoku_csp(geom, config),
        config,
        step_limit=int(state.steps) + int(steps_delta),
    )
    return new, chunk_status(state.steps, state.lane_rounds, new)
