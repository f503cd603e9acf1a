"""Lane-sharded fused solve: K2 (Sudoku) or K3 (exact cover) on every shard.

Port of the JAX package's ``parallel/fused_sharded.py``.  The fused
driver's round (``ops.cuda_step._fused_round``: one kernel launch on a
lane block, then the job harvest, purge and local steal) runs on each
shard's block, and the cross-shard merges of :mod:`.sharded` follow:

* **per shard, per round**: one launch of K2 or K3 (the shard's round
  function, ``_rounds_fn`` of ``ops.cuda_step`` or ``ops.cuda_cover``) on
  the shard's lanes, then the local bookkeeping;
* **SOLUTION_FOUND**: newly solved flags merge with a psum, the winner is
  the lowest shard that solved the job (``pmin`` over shard indices);
* **NEEDWORK / TASK**: the ring steal of :mod:`.sharded` (the port keeps
  one lane-first layout for both drivers, so the JAX package's
  boards-last twin ``_ring_steal_t`` is the same function here);
* **step lockstep**: each shard's ``steps`` advances by its own busiest
  lane's rounds, which diverge across shards, so the round ``pmax``es it
  and the loop condition reads the replicated value.

Held to the JAX package's fused contract: verdicts and solutions equal,
``count_all`` counts exact; ``sweeps`` is a per-lane sum in the port
(``ops/cuda_step.py``).  On CUDA tensors every round launches the kernel;
nothing falls back to the plain version.  On a process mesh each process
launches the kernel on its own shards' blocks, and the winner's key is the
global shard index, so every process picks JAX's lowest shard.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.cuda_bookkeep import _fused_live
from distributed_sudoku_solver_tpu_torch.ops.cuda_step import _fused_round, _rounds_fn, fused_lanes
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    FUSED_STEPS_DEVICE,
    FUSED_STEPS_LINKED,
    SolverConfig,
    init_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import (
    SolveResult,
    _as_tensor,
    _decode_solution,
)
from distributed_sudoku_solver_tpu_torch.parallel import collectives as C
from distributed_sudoku_solver_tpu_torch.parallel.mesh import Mesh, default_mesh
from distributed_sudoku_solver_tpu_torch.parallel.sharded import (
    _any_live,
    _ring_steal,
    finalize_sharded,
    shard_lanes,
)


def _fused_round_sharded(fss, config: SolverConfig, mesh: Mesh, rounds_fn) -> list:
    """One fused dispatch of ``rounds_fn`` and the local bookkeeping on
    every shard, then the cross-shard merges (every merge below is
    shape-generic, so K2 and K3 share them)."""
    n_dev = mesh.size
    n_jobs = fss[0].solved.shape[0]
    prev_solved, prev_solution = fss[0].solved, fss[0].solution

    fss = [_fused_round(fs, config, rounds_fn) for fs in fss]

    # --- merge job resolution across shards (the SOLUTION_FOUND broadcast) --
    newly = [fs.solved & ~prev_solved.to(fs.solved.device) for fs in fss]
    newly_any = [x > 0 for x in C.psum([x.to(torch.int32) for x in newly], mesh)]
    keys = [torch.where(nw, torch.full_like(nw, g, dtype=torch.int32),
                        torch.full_like(nw, n_dev, dtype=torch.int32))
            for g, nw in zip(mesh.local, newly)]
    winner = C.pmin(keys, mesh)
    contrib = [torch.where((nw & (k == wn))[:, None, None], fs.solution,
                           torch.zeros_like(fs.solution))
               for nw, k, wn, fs in zip(newly, keys, winner, fss)]
    merged = C.psum(contrib, mesh)
    overflowed = [x > 0 for x in C.psum([fs.overflowed.to(torch.int32) for fs in fss], mesh)]
    steps = C.pmax([fs.steps for fs in fss], mesh)

    solved, solution, has_tops, counts, job_lives = [], [], [], [], []
    for i, fs in enumerate(fss):
        s_i = prev_solved.to(fs.solved.device) | newly_any[i]
        solved.append(s_i)
        solution.append(torch.where(newly_any[i][:, None, None], merged[i],
                                    prev_solution.to(fs.solution.device)))
        # Purge lanes of globally resolved jobs before the ring steal.
        job_live = (fs.job >= 0) & ~s_i[torch.clamp(fs.job, 0, n_jobs - 1).long()]
        job_lives.append(job_live)
        has_tops.append(fs.has_top & job_live)
        counts.append(torch.where(job_live, fs.count, torch.zeros_like(fs.count)))
    tops = [fs.top for fs in fss]
    bases = [fs.base for fs in fss]
    jobs = [fs.job for fs in fss]
    steals = [fs.steals for fs in fss]
    if n_dev > 1 and config.steal and config.ring_steal_k > 0:
        tops, has_tops, bases, counts, jobs, shipped = _ring_steal(
            tops, has_tops, [fs.stack for fs in fss], bases, counts, jobs, job_lives, mesh,
            config.ring_steal_k,
        )
        steals = [s + n for s, n in zip(steals, shipped)]

    return [
        fs._replace(
            top=tops[i], has_top=has_tops[i], base=bases[i], count=counts[i], job=jobs[i],
            solved=solved[i], solution=solution[i], overflowed=overflowed[i],
            # Enumeration accumulates disjoint per-shard subtree counts
            # (summed at finalize); find-one mirrors the merged solved flags.
            sol_count=fs.sol_count if config.count_all else solved[i].to(torch.int32),
            steps=steps[i], steals=steals[i],
        )
        for i, fs in enumerate(fss)
    ]


def _run_fused_sharded(fss, config: SolverConfig, mesh: Mesh, rounds_fn) -> SolveResult:
    """The solve loop and the finalize psums over per-shard fused frontiers."""
    while _any_live(fss, _fused_live, mesh, config.max_steps):
        fss = _fused_round_sharded(fss, config, mesh, rounds_fn)
    res = finalize_sharded(fss, mesh, _fused_live)
    if config.count_all:
        # Exact global model count: per-shard counts are disjoint-subtree
        # sums.  Per-shard first solutions diverge under enumeration (no
        # resolution event merges them), so the solution field is zeroed:
        # counts, not solutions, are the product.
        return res._replace(solution=torch.zeros_like(res.solution))
    return res._replace(sol_count=fss[0].sol_count.to(res.solved.device))


def _per_shard_config(config: SolverConfig, n_jobs: int, n_dev: int, width) -> SolverConfig:
    """Each shard's lane block must itself be a kernel-valid width: size
    per shard first (``width``), then scale by the mesh."""
    per_shard = width(-(-config.resolve_lanes(n_jobs) // n_dev))
    return dataclasses.replace(config, lanes=per_shard * n_dev)


def solve_batch_fused_sharded(grids, geom: Geometry,
                              config: SolverConfig = SolverConfig(step_impl="fused"),
                              mesh: Mesh | None = None, device=None) -> SolveResult:
    """Fused-step solve of int grids [J, n, n], lanes sharded over ``mesh``
    (default: every visible device of ``device``, which ``None`` makes CUDA)."""
    mesh = mesh if mesh is not None else default_mesh(device)
    grids = _as_tensor(grids, mesh.devices[0])
    # Device-resident surface: fused_steps=None resolves deep.
    config = config.with_fused_steps(FUSED_STEPS_DEVICE)
    cfg = _per_shard_config(config, grids.shape[0], mesh.size,
                            lambda w: fused_lanes(w, geom.n, config.stack_slots))
    state = init_frontier(encode_grid(grids, geom), cfg)
    rounds = _rounds_fn(geom, cfg, cfg.lanes // mesh.size)
    return _decode_solution(_run_fused_sharded(shard_lanes(state, mesh), cfg, mesh, rounds))


def solve_csp_fused_sharded(states0, problem,
                            config: SolverConfig = SolverConfig(step_impl="fused"),
                            mesh: Mesh | None = None, device=None) -> SolveResult:
    """Fused exact-cover solve (K3 on every shard) with lanes sharded over
    ``mesh``: ``parallel.solve_csp_sharded``'s contract (raw solved states;
    exact summed counts under ``count_all``)."""
    from distributed_sudoku_solver_tpu_torch.models.cover import ExactCoverCSP
    from distributed_sudoku_solver_tpu_torch.ops.cuda_cover import (
        _rounds_fn as cover_rounds_fn,
        cover_fused_lanes,
        launch_shape,
    )

    if not isinstance(problem, ExactCoverCSP):
        raise ValueError(
            f"solve_csp_fused_sharded takes an exact-cover instance, got {type(problem).__name__}"
        )
    mesh = mesh if mesh is not None else default_mesh(device)
    states0 = _as_tensor(states0, mesh.devices[0])
    # Cover keeps the shallow fused_steps default on every surface.
    config = config.with_fused_steps(FUSED_STEPS_LINKED)
    launch_shape(problem)  # an instance K3 cannot take raises before the first dispatch
    cfg = _per_shard_config(config, states0.shape[0], mesh.size, cover_fused_lanes)
    state = init_frontier(states0, cfg)
    rounds = cover_rounds_fn(problem, cfg, cfg.lanes // mesh.size)
    return _run_fused_sharded(shard_lanes(state, mesh), cfg, mesh, rounds)

