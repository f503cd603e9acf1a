"""Bulk solver: one solve per chunk for very large batches.

Port of the JAX package's ``ops/bulk.py``.  Each chunk is one
``solve_batch_wire`` call (with ``mesh=``, one
``parallel.sharded.solve_batch_sharded_wire`` call, lanes sharded over
the mesh's shards): the frontier's first
round is the propagation pass, and boards that close under propagation
free their lanes for the hard ones.  Unresolved stragglers (overflowed or
out of steps) escalate through rungs with OR-parallel thief gangs and deep
stacks, advanced in bounded-step chunks.

The first pass keeps up to ``BulkConfig.inflight`` chunks in flight, as
the JAX package does: the main thread packs, uploads and solves chunk k+1
while one drain worker fetches and unpacks chunk k, in chunk order.

Automatic choices name the card's kernels where the JAX package names the
TPU's: on CUDA the first pass runs the fused round kernel
(``step_impl='fused'``) and the composite steps the fixpoint kernel
(``propagator='pallas'``); on the CPU both are the plain torch versions of
the composite path, as the JAX package runs on a CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops import wire
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    FUSED_STEPS_LINKED,
    SolverConfig,
    unpack_status,
)
from distributed_sudoku_solver_tpu_torch.ops.propagate import RULE_TIERS
from distributed_sudoku_solver_tpu_torch.ops.solve import (
    _finalize,
    resolve_device,
    solve_batch_wire,
)
from distributed_sudoku_solver_tpu_torch.serving import faults
from distributed_sudoku_solver_tpu_torch.utils.puzzles import solved_board


@dataclasses.dataclass(frozen=True)
class BulkConfig:
    """Static bulk-pipeline configuration (the JAX package's fields)."""

    chunk: int = 32768  # boards (= frontier lanes) per dispatch
    stack_slots: int = 12  # first-pass DFS depth
    max_steps: int = 100_000
    max_sweeps: int = 64
    propagator: Optional[str] = None  # None = auto ('pallas' on CUDA, 'xla' on CPU)
    rules: str = "extended"
    # Escalation rungs: (max jobs/chunk, lanes per job, stack slots[, step
    # budget]); None = geometry default (default_rungs).
    rungs: Optional[tuple] = None
    inflight: int = 3  # first-pass chunks solved ahead of the oldest one's drain
    first_pass_steps: int = 4096
    dispatch_steps: int = 512
    rung_stack_mb: int = 768  # cap on a rung's stack tensor (lanes x slots)
    step_impl: Optional[str] = None  # None = auto ('fused' on CUDA, 'xla' on CPU)
    fused_steps: Optional[int] = None  # None = FUSED_STEPS_LINKED on the first pass
    rung_step_impl: Optional[str] = None  # None = auto ('fused' on CUDA for n >= 16)

    def __post_init__(self) -> None:
        if self.propagator not in (None, "xla", "pallas", "slices"):
            raise ValueError(f"unknown propagator {self.propagator!r}")
        if self.rules not in RULE_TIERS:
            raise ValueError(f"unknown rules {self.rules!r}")
        if self.step_impl not in (None, "xla", "fused"):
            raise ValueError(f"unknown step_impl {self.step_impl!r}")
        if self.rung_step_impl not in (None, "xla", "fused"):
            raise ValueError(f"unknown rung_step_impl {self.rung_step_impl!r}")


def default_rungs(geom: Geometry) -> tuple:
    """Geometry-resolved escalation ladder (``BulkConfig.rungs=None``)."""
    if geom.n >= 16:
        return ((64, 128, 24), (64, 16, 256))
    return ((2048, 4, 64, 16_384), (64, 64, 256))


@dataclasses.dataclass
class BulkResult:
    """Per-board verdicts for one bulk call (host-side numpy)."""

    solution: np.ndarray  # int32[B, n, n]; zeros where unsolved
    solved: np.ndarray  # bool[B]
    unsat: np.ndarray  # bool[B]
    by_propagation: np.ndarray  # bool[B]: solved with zero search
    searched: int  # boards that needed at least one branch node


def solve_bulk(
    grids,
    geom: Geometry,
    config: BulkConfig = BulkConfig(),
    mesh=None,
    trace: Optional[dict] = None,
    device=None,
) -> BulkResult:
    """Solve ``grids`` int[B, n, n] (0 = empty); B may be huge.

    Results are independent of chunk sizes and of ``config.inflight``.
    With ``trace`` (a dict), per-stage host wall clocks are recorded into
    it: ``pack_s`` (pack and upload), ``solve_s`` (the chunk solves, on the
    main thread), ``drain_s`` (each chunk's result fetch and unpack, on the
    drain worker), ``first_pass_s``, ``remaining_after_first`` and per-rung
    dicts under ``rungs``.  With ``inflight`` above 1 the drain of one
    chunk overlaps the pack and solve of the next, so the three stages can
    add up to more than ``first_pass_s``.

    ``faults.fire("bulk.dispatch")`` (``serving/faults.py``) runs before
    each first-pass chunk's pack and before each rung dispatch: an
    installed fault injector can fail either, as in the JAX package.

    With ``mesh`` (``parallel.mesh.Mesh``), the chunks and the rungs run
    the sharded frontier (``parallel/sharded.py``; a fused first pass runs
    K2 on every shard), each chunk's lanes padded evenly over the shards,
    in the packed wire format the sharded driver speaks; rungs take one
    sharded solve each, composite, as in the JAX package.  ``device`` is
    then the mesh's first shard's."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    n_dev = 1 if mesh is None else mesh.size
    on_cuda = dev.type == "cuda"
    grids = np.ascontiguousarray(np.asarray(grids, dtype=np.int32))
    b, n, _ = grids.shape

    solution = np.zeros((b, n, n), dtype=np.int32)
    solved = np.zeros(b, dtype=bool)
    unsat = np.zeros(b, dtype=bool)
    branched = np.zeros(b, dtype=bool)

    pad_board = solved_board(geom)
    prop = config.propagator or ("pallas" if on_cuda else "xla")
    fmt = wire.best_format(geom) if mesh is None else "packed"

    def run_chunk(packed: torch.Tensor, scfg: SolverConfig) -> torch.Tensor:
        if mesh is not None:
            from distributed_sudoku_solver_tpu_torch.parallel.sharded import (
                solve_batch_sharded_wire,
            )

            return solve_batch_sharded_wire(packed, geom, scfg, mesh)
        return solve_batch_wire(packed, geom, scfg, fmt=fmt, device=dev)

    def pad_to(batch: np.ndarray, size: int) -> np.ndarray:
        # Pad with a complete board: its lane resolves on round one and
        # turns thief for the real jobs; one shape serves every chunk.
        if len(batch) == size:
            return batch
        pad = np.tile(pad_board[None], (size - len(batch), 1, 1))
        return np.concatenate([batch, pad])

    chunk = min(config.chunk, max(64, 1 << (max(b, 1) - 1).bit_length()))
    chunk = max(n_dev, -(-chunk // n_dev) * n_dev)
    step_impl = config.step_impl or ("fused" if on_cuda else "xla")
    first_cfg = SolverConfig(
        lanes=chunk,
        stack_slots=config.stack_slots,
        max_steps=min(config.first_pass_steps, config.max_steps),
        max_sweeps=config.max_sweeps,
        propagator=prop,
        rules=config.rules,
        step_impl=step_impl,
        fused_steps=config.fused_steps,
    ).with_fused_steps(FUSED_STEPS_LINKED)

    stage = {"pack_s": 0.0, "solve_s": 0.0, "drain_s": 0.0}
    # The solve's stream: the drain worker fetches on it, so its copy is
    # ordered after the chunk's kernels (a new thread starts on the
    # default stream, whatever the caller's current stream is).
    stream = torch.cuda.current_stream(dev) if on_cuda else None

    def drain(lo: int, res: torch.Tensor) -> None:
        t0 = time.perf_counter()
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            fetched = res.cpu().numpy()  # the one result fetch per chunk
        hi = min(lo + chunk, b)
        k = hi - lo
        r_sol, r_solved, r_unsat, r_branched = wire.unpack_result_for(fetched, geom, fmt)
        r_sol, r_solved = r_sol[:k], r_solved[:k]
        solution[lo:hi][r_solved] = r_sol[r_solved]
        solved[lo:hi] = r_solved
        unsat[lo:hi] = r_unsat[:k]
        branched[lo:hi] = r_branched[:k]
        stage["drain_s"] += time.perf_counter() - t0

    # One drain worker keeps the drains in chunk order, and each writes its
    # own rows of the result arrays.  The upload is a blocking copy from
    # pageable memory, so no host buffer has to outlive its chunk's call.
    t_first = time.perf_counter()
    pending: list = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for lo in range(0, b, chunk):
            batch = pad_to(grids[lo : lo + chunk], chunk)
            faults.fire("bulk.dispatch")
            t0 = time.perf_counter()
            packed = torch.from_numpy(wire.pack_grids_for(batch, geom, fmt)).to(dev)
            t1 = time.perf_counter()
            res = run_chunk(packed, first_cfg)
            stage["pack_s"] += t1 - t0
            stage["solve_s"] += time.perf_counter() - t1
            pending.append(pool.submit(drain, lo, res))
            if len(pending) >= max(1, config.inflight):
                pending.pop(0).result()
        for f in pending:
            f.result()

    by_propagation = solved & ~branched
    searched = int(branched.sum())
    if trace is not None:
        trace.update(stage)
        trace["first_pass_s"] = time.perf_counter() - t_first
        trace["chunks"] = -(-b // chunk)
        trace["inflight"] = max(1, config.inflight)
        trace["step_impl"] = step_impl
        trace["fused_steps"] = first_cfg.fused_steps
        trace["remaining_after_first"] = int((~solved & ~unsat).sum())
        trace["rungs"] = []

    dispatches = [0]

    def run_rung_stepped(batch: np.ndarray, scfg: SolverConfig):
        from distributed_sudoku_solver_tpu_torch.utils.checkpoint import (
            advance_frontier_status,
            start_frontier,
        )

        if mesh is not None:
            # The sharded driver loops to the end in one call; multi-device
            # rungs keep that one-dispatch path, as in the JAX package.
            faults.fire("bulk.dispatch")
            res = run_chunk(torch.from_numpy(wire.pack_grids_host(batch, geom)).to(dev), scfg)
            dispatches[0] += 1
            return wire.unpack_result_host(res.cpu().numpy(), geom)
        if scfg.step_impl == "fused":
            from distributed_sudoku_solver_tpu_torch.ops.cuda_step import (
                advance_frontier_fused_status as advance,
            )
        else:
            advance = advance_frontier_status
        state = start_frontier(torch.from_numpy(batch.astype(np.int32)).to(dev), geom, scfg)
        n_rung_jobs = len(batch)
        while True:
            faults.fire("bulk.dispatch")
            state, status = advance(state, config.dispatch_steps, geom, scfg)
            dispatches[0] += 1
            info = unpack_status(status, n_rung_jobs)
            if not info["has_work"].any() or info["steps"] >= scfg.max_steps:
                break
        res = _finalize(state)
        packed = wire.pack_result_device(res.solution, res.solved, res.unsat, res.nodes > 0, geom)
        return wire.unpack_result_host(packed.cpu().numpy(), geom)

    remaining = np.flatnonzero(~solved & ~unsat)
    rungs = default_rungs(geom) if config.rungs is None else config.rungs
    for rung in rungs:
        if len(remaining) == 0:
            break
        max_jobs, lanes_per_job, slots = rung[:3]
        rung_steps = (
            min(int(rung[3]), config.max_steps) if len(rung) > 3 else config.max_steps
        )
        jobs_per_chunk = min(max_jobs, max(64, 1 << (len(remaining) - 1).bit_length()))
        budget = config.rung_stack_mb << 20
        cell_bytes = n * n * 4
        while jobs_per_chunk * lanes_per_job * slots * cell_bytes > budget and lanes_per_job > 1:
            lanes_per_job //= 2
        while jobs_per_chunk * lanes_per_job * slots * cell_bytes > budget and jobs_per_chunk > 64:
            jobs_per_chunk //= 2
        rung_lanes = -(-(jobs_per_chunk * lanes_per_job) // n_dev) * n_dev
        rung_impl = "xla"
        want_fused = config.rung_step_impl == "fused" or (
            config.rung_step_impl is None and on_cuda and n >= 16
        )
        if want_fused and mesh is None:
            rung_impl = "fused"
            rung_lanes = -(-rung_lanes // 128) * 128
        scfg = SolverConfig(
            lanes=rung_lanes,
            stack_slots=slots,
            max_steps=rung_steps,
            max_sweeps=config.max_sweeps,
            propagator=prop,
            rules=config.rules,
            step_impl=rung_impl,
            steal_rounds=4 if lanes_per_job > 1 else 1,
        )
        still: list[int] = []
        t_rung = time.perf_counter()
        dispatches[0] = 0
        for lo in range(0, len(remaining), jobs_per_chunk):
            idx = remaining[lo : lo + jobs_per_chunk]
            r_sol, r_solved, r_unsat, _ = run_rung_stepped(
                pad_to(grids[idx], jobs_per_chunk), scfg
            )
            r_sol, r_solved, r_unsat = r_sol[: len(idx)], r_solved[: len(idx)], r_unsat[: len(idx)]
            solution[idx] = np.where(r_solved[:, None, None], r_sol, 0)
            solved[idx] = r_solved
            unsat[idx] = r_unsat
            still.extend(idx[~r_solved & ~r_unsat])
        if trace is not None:
            trace["rungs"].append({
                "wall_s": time.perf_counter() - t_rung,
                "rung": tuple(int(x) for x in rung),
                "lanes": int(scfg.lanes),
                "slots": int(scfg.stack_slots),
                "step_impl": rung_impl,
                "dispatches": dispatches[0],
                "survivors_in": len(remaining),
                "survivors_out": len(still),
            })
        remaining = np.asarray(still, dtype=remaining.dtype)

    return BulkResult(
        solution=solution,
        solved=solved,
        unsat=unsat,
        by_propagation=by_propagation,
        searched=searched,
    )
