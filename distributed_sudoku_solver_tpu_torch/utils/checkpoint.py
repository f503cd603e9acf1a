"""Checkpoint / resume: the frontier tensor is the checkpoint.

Port of the JAX package's ``utils/checkpoint.py``: start a frontier from
grids, advance it in bounded-step chunks, snapshot it to a ``.npz`` between
chunks (atomic rename), and resume by loading it and stepping on.  The
advances update the frontier's stack in place (the JAX versions donate
the state): callers rebind the returned state and drop the old one.

The snapshot format is the JAX package's, so a snapshot crosses between the
two packages: every ``Frontier`` field under its own name, masks as uint32
(the port's int32 tensors carry the same bits), and a ``__signature__``
that names the problem, every ``SolverConfig`` field (the two packages'
configs share names, order and defaults) and a digest of the grids.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    Frontier,
    SolverConfig,
    chunk_status,
    frontier_from_numpy,
    frontier_live,
    frontier_to_numpy,
    init_frontier,
    run_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import (
    SolveResult,
    _as_tensor,
    _finalize,
    resolve_device,
    sudoku_csp,
)


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
    ``(new_state, packed status)`` (``ops.frontier.chunk_status``).  The
    limit is formed on the device, so the host does not read the steps
    for it; ``run_frontier`` still reads its loop condition before the
    first round (ROADMAP A8).  ``status`` is a fresh tensor that later
    chunks never write."""
    new = run_frontier(
        state,
        sudoku_csp(geom, config),
        config,
        step_limit=state.steps + steps_delta,
    )
    return new, chunk_status(state.steps, state.lane_rounds, new)


def frontier_done(state: Frontier) -> bool:
    return not bool(frontier_live(state).any())


def _signature(geom: Geometry, config: SolverConfig, grids_hash: Optional[str] = None) -> str:
    return json.dumps(
        {
            "problem": sudoku_csp(geom, config).signature(),
            "config": dataclasses.asdict(config),
            "grids": grids_hash,
        }
    )


def grids_digest(grids) -> str:
    """Content hash of the job batch: a checkpoint resumes only its own inputs."""
    if isinstance(grids, torch.Tensor):
        grids = grids.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(grids, dtype=np.int32))
    return hashlib.sha256(arr.tobytes() + str(arr.shape).encode()).hexdigest()[:16]


def save_frontier(
    path: str,
    state: Frontier,
    geom: Geometry,
    config: SolverConfig,
    grids_hash: Optional[str] = None,
) -> None:
    """Atomic snapshot: device -> host -> tmpfile -> rename."""
    host = frontier_to_numpy(state)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f, __signature__=np.frombuffer(
                    _signature(geom, config, grids_hash).encode(), dtype=np.uint8
                ), **host,
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_frontier(
    path: str,
    geom: Geometry,
    config: SolverConfig,
    grids_hash: Optional[str] = None,
    device=None,
) -> Frontier:
    """Read a snapshot that :func:`save_frontier` (of either package) wrote
    for the same problem, config and grids; raise ``ValueError`` otherwise.
    The frontier lands on ``device`` (``None``: CUDA, raising without it,
    as every entry point of the package)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        sig = bytes(data["__signature__"]).decode()
        want = _signature(geom, config, grids_hash)
        if sig != want:
            raise ValueError(f"checkpoint signature mismatch: saved {sig}, requested {want}")
        return frontier_from_numpy({k: data[k] for k in Frontier._fields}, device=dev)


def solve_batch_checkpointed(
    grids,
    geom: Geometry,
    config: SolverConfig = SolverConfig(),
    checkpoint_path: Optional[str] = None,
    chunk_steps: int = 256,
    resume: bool = True,
    on_chunk: Optional[Callable[[Frontier], None]] = None,
    device=None,
) -> SolveResult:
    """Solve with a snapshot after every chunk, resuming from an existing one.

    If ``checkpoint_path`` exists and ``resume``, the run continues where the
    file left off, with the same search order, so the result is
    bit-identical to an uninterrupted run; the file is removed on
    completion.  ``on_chunk`` sees the frontier after each saved chunk; the
    next chunk updates its stack in place, so a callback that keeps the
    state copies it first."""
    dev = resolve_device(device)
    grids = _as_tensor(grids, dev)
    ghash = grids_digest(grids)
    state = None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        state = load_frontier(checkpoint_path, geom, config, grids_hash=ghash, device=dev)
    if state is None:
        state = start_frontier(grids, geom, config)

    while True:
        limit = min(int(state.steps) + chunk_steps, config.max_steps)
        state = advance_frontier(state, limit, geom, config)
        if frontier_done(state) or int(state.steps) >= config.max_steps:
            break
        if checkpoint_path:
            save_frontier(checkpoint_path, state, geom, config, grids_hash=ghash)
        if on_chunk is not None:
            on_chunk(state)

    if checkpoint_path and os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    return _finalize(state)
