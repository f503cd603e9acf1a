"""Lane-sharded frontier solve: the composite step on every shard of a mesh.

Port of the JAX package's ``parallel/sharded.py``, the reference's whole
distributed layer re-expressed as collectives over per-shard lists
(:mod:`.collectives`):

* **shard = ring node.**  The frontier's lane axis is cut into contiguous
  blocks, one per shard; per-job rows (``solved``, ``solution``,
  ``overflowed``) are replicated.  Every round runs
  ``ops.frontier.frontier_step`` on each shard's block, then the merges.
* **SOLUTION_FOUND = one fused psum per round.**  Each shard contributes
  its newly solved flags as a one-hot row over shards, its overflow flags,
  its liveness and its candidate solution rows, all int32 bit patterns;
  after the one sum the lowest shard that solved a job supplies its
  solution.  The liveness term is summed before the remote solved flags
  land, so the mesh-resident loop (:mod:`.mesh_resident`) runs one no-op
  round late, never early, as in JAX.
* **NEEDWORK / TASK = a receiver-initiated ring ppermute.**  Each shard
  tells its ring predecessor how many idle lanes it has; the predecessor
  pops up to that many bottom stack rows from its donors and ships them
  forward in one payload, deleting exactly what it ships.  Every payload
  is computed before the rotation and installed after it.
* **STATS = psums at finalize.**  Per-shard counters are summed once.

The loop condition (any live lane on any shard, and the step budget) is
read on the host once per round, not once per shard.  Results are
bit-identical to the JAX package's on every field.

On a process mesh (:func:`.mesh.make_process_mesh`) each process keeps only
its own shards' blocks in its lists, and every shard index below is the
global one (``mesh.local``); every process passes the same input and gets
the same replicated result.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import encode_grid
from distributed_sudoku_solver_tpu_torch.ops.csp import CSProblem
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    _lane_by_rank,
    _scatter_max_bool,
    _set_rows,
    frontier_live,
    frontier_step,
    init_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import (
    SolveResult,
    _as_tensor,
    _decode_solution,
    sudoku_csp,
)
from distributed_sudoku_solver_tpu_torch.parallel import collectives as C
from distributed_sudoku_solver_tpu_torch.parallel.mesh import Mesh, default_mesh

# Frontier fields sharded over the lane axis; the rest are replicated.
LANE_FIELDS = ("top", "has_top", "stack", "base", "count", "job", "lane_rounds")


def shard_lanes(state, mesh: Mesh) -> list:
    """A global (lane-first) frontier -> one per local shard: contiguous lane
    blocks for :data:`LANE_FIELDS`, a copy of every other field."""
    n_lanes = state.has_top.shape[0]
    if n_lanes % mesh.size:
        raise ValueError(f"lanes={n_lanes} do not divide over {mesh.size} shards")
    per = n_lanes // mesh.size
    out = []
    for g, dev in zip(mesh.local, mesh.devices):
        fields = {}
        for name, v in state._asdict().items():
            if name in LANE_FIELDS:
                v = v[g * per:(g + 1) * per]
            fields[name] = v.to(dev).contiguous()
        out.append(type(state)(**fields))
    return out


def mesh_lanes(lanes: int, n_dev: int) -> int:
    """Round a lane count up to a multiple of the mesh size."""
    return -(-lanes // n_dev) * n_dev


def _any_live(states, live_fn, mesh: Mesh, max_steps: int) -> bool:
    """The replicated loop condition, one host read: a live lane on any
    shard and ``steps < max_steps`` (``steps`` is replicated)."""
    return C.any_host([live_fn(s).any() & (s.steps < max_steps) for s in states], mesh)


def _ring_steal(tops, has_tops, stacks, bases, counts, jobs, job_lives, mesh: Mesh, k: int,
                install_ok=None):
    """Ship up to ``k`` bottom stack rows from each shard to its ring successor.

    Receiver-initiated and work-conserving: the successor advertises its
    idle-lane count, the donor ships ``min(request, donors, k)`` rows and
    deletes exactly those (a bottom-pointer bump), and the receiver installs
    every row it gets into idle lanes' tops.  ``install_ok`` (one bool[L]
    per shard, optional) restricts which idle lanes may receive foreign
    rows: the mesh-resident flight excludes home lanes.  Returns the new
    per-shard ``(tops, has_tops, bases, counts, jobs, installed)``."""
    n_dev = mesh.size
    n_local = len(has_tops)
    n_lanes, s = stacks[0].shape[:2]
    h, w = stacks[0].shape[2:]
    n_cells = h * w
    k = min(k, n_lanes)

    idles = [~ht if install_ok is None else (~ht & ok)
             for ht, ok in zip(has_tops, install_ok or [None] * n_local)]
    request = C.ppermute([i.sum(dtype=torch.int32) for i in idles], C.ring_backward(n_dev), mesh)

    payloads, new_bases, new_counts = [], [], []
    for i in range(n_local):
        has_top, stack, base, count, job = has_tops[i], stacks[i], bases[i], counts[i], jobs[i]
        dev = has_top.device
        slot_k = torch.arange(k, dtype=torch.int32, device=dev)
        donor = has_top & (count >= 1) & job_lives[i]
        donor_of = _lane_by_rank(donor, n_lanes)
        n_send = torch.clamp(torch.minimum(request[i], donor.sum(dtype=torch.int32)), max=k)
        take = slot_k < n_send
        donor_lane = torch.where(take, donor_of[:k], torch.full_like(slot_k, n_lanes))
        safe = torch.clamp(donor_lane, 0, n_lanes - 1).long()
        rows = stack[safe, (base[safe] % s).long()]
        boards = torch.where(take[:, None, None], rows, torch.zeros_like(rows))
        jobs_out = torch.where(take, job[safe], torch.full_like(slot_k, -1))
        donor_sel = _set_rows(torch.zeros(n_lanes, dtype=torch.bool, device=dev), donor_lane, True)
        new_bases.append(torch.where(donor_sel, (base + 1) % s, base))
        new_counts.append(torch.where(donor_sel, count - 1, count))
        # One payload (boards || job tag, plus a count row) instead of three
        # rotations; int32 job tags (-1 padding) ride the int32 words exactly.
        payload = torch.zeros((k + 1, n_cells + 1), dtype=torch.int32, device=dev)
        payload[:k, :n_cells] = boards.reshape(k, n_cells)
        payload[:k, n_cells] = jobs_out
        payload[k, 0] = n_send
        payloads.append(payload)
    arrived = C.ppermute(payloads, C.ring_forward(n_dev), mesh)

    out_tops, out_has, out_jobs, installed = [], [], [], []
    for i in range(n_local):
        payload = arrived[i]
        dev = payload.device
        boards_in = payload[:k, :n_cells].reshape(k, h, w)
        jobs_in = payload[:k, n_cells]
        n_in = payload[k, 0]
        slot_k = torch.arange(k, dtype=torch.int32, device=dev)
        install = slot_k < n_in
        thief_of = _lane_by_rank(idles[i], n_lanes)
        thief_lane = torch.where(install, thief_of[:k], torch.full_like(slot_k, n_lanes))
        out_tops.append(_set_rows(tops[i], thief_lane, boards_in))
        out_has.append(_set_rows(has_tops[i], thief_lane, install))
        out_jobs.append(_set_rows(jobs[i], thief_lane, jobs_in))
        installed.append(n_in)
    return out_tops, out_has, new_bases, new_counts, out_jobs, installed


def _sharded_step_counted(states, problem: CSProblem, config: SolverConfig, mesh: Mesh,
                          ring_install_ok=None):
    """One lockstep round on every shard: the local step, then the merges.

    Returns ``(new states, rows installed per local shard this round, the
    number of shards with a live lane before the merge)``, the last a 0-d
    int32 on the first local shard's device.  The whole resolution merge is one fused
    psum (see the module docstring)."""
    n_dev = mesh.size
    n_jobs = states[0].solved.shape[0]
    prev_solved, prev_solution = states[0].solved, states[0].solution
    d0 = mesh.devices[0]

    sts = [frontier_step(s, problem, config) for s in states]

    # --- merge job resolution across shards: ONE fused psum ---------------
    fused = []
    for g, st in zip(mesh.local, sts):
        dev = st.solved.device
        newly = st.solved & ~prev_solved.to(dev)
        onehot = torch.arange(n_dev, device=dev) == g
        newly_oh = newly[:, None] & onehot[None, :]  # [J, D]
        sol_by_dev = torch.where(newly_oh[:, :, None, None], st.solution[:, None],
                                 torch.zeros((), dtype=torch.int32, device=dev))
        live_local = frontier_live(st).any()
        fused.append(torch.cat([
            newly_oh.to(torch.int32).reshape(-1),
            st.overflowed.to(torch.int32),
            live_local.to(torch.int32).reshape(1),
            sol_by_dev.reshape(-1),
        ]))
    total = C.psum(fused, mesh)[0]  # replicated: merged once, then copied
    jd = n_jobs * n_dev
    newly_mat = total[:jd].reshape(n_jobs, n_dev) > 0
    overflowed = total[jd:jd + n_jobs] > 0
    live_count = total[jd + n_jobs]
    sols = total[jd + n_jobs + 1:].reshape(n_jobs, n_dev, *prev_solution.shape[1:])
    newly_any = newly_mat.any(1)
    winner = torch.argmax(newly_mat.to(torch.int32), dim=1)  # first True = lowest shard
    contrib = sols[torch.arange(n_jobs, device=d0), winner]
    solution = torch.where(newly_any[:, None, None], contrib, prev_solution.to(d0))
    solved = prev_solved.to(d0) | newly_any
    rep = {k: C.replicate(v, mesh) for k, v in
           (("solved", solved), ("solution", solution), ("overflowed", overflowed))}

    # --- cross-shard work rebalance (NEEDWORK over the ring) ----------------
    tops = [st.top for st in sts]
    has_tops = [st.has_top for st in sts]
    bases = [st.base for st in sts]
    counts = [st.count for st in sts]
    jobs = [st.job for st in sts]
    shipped = [torch.zeros((), dtype=torch.int32, device=st.top.device) for st in sts]
    if n_dev > 1 and config.steal and config.ring_steal_k > 0:
        job_lives = []
        for i in range(len(sts)):
            job_safe = torch.clamp(jobs[i], 0, n_jobs - 1).long()
            job_live = (jobs[i] >= 0) & ~rep["solved"][i][job_safe]
            job_lives.append(job_live)
            has_tops[i] = has_tops[i] & job_live
            counts[i] = torch.where(job_live, counts[i], torch.zeros_like(counts[i]))
        tops, has_tops, bases, counts, jobs, shipped = _ring_steal(
            tops, has_tops, [st.stack for st in sts], bases, counts, jobs, job_lives, mesh,
            config.ring_steal_k, ring_install_ok,
        )

    out = [
        st._replace(
            top=tops[i], has_top=has_tops[i], base=bases[i], count=counts[i], job=jobs[i],
            solved=rep["solved"][i], solution=rep["solution"][i],
            overflowed=rep["overflowed"][i], steals=st.steals + shipped[i],
        )
        for i, st in enumerate(sts)
    ]
    return out, shipped, live_count


def finalize_sharded(states, mesh: Mesh, live_fn) -> SolveResult:
    """The finalize psums: per-shard counters -> global totals on the first
    local shard's device (``sol_count`` summed too; the callers apply their
    find-one and enumeration contracts to it)."""
    d0 = mesh.devices[0]
    st0 = states[0]
    n_jobs = st0.solved.shape[0]
    has_work = C.psum([
        _scatter_max_bool(n_jobs, torch.clamp(s.job, 0, n_jobs - 1), live_fn(s)).to(torch.int32)
        for s in states], mesh)[0] > 0
    solved, overflowed = st0.solved.to(d0), st0.overflowed.to(d0)

    def total(name):
        return C.psum([getattr(s, name) for s in states], mesh)[0]

    return SolveResult(
        solution=st0.solution.to(d0), solved=solved,
        unsat=~solved & ~has_work & ~overflowed, overflowed=overflowed,
        nodes=total("nodes"), sol_count=total("sol_count"), steps=st0.steps.to(d0),
        sweeps=total("sweeps"), expansions=total("expansions"), steals=total("steals"),
    )


def _run_sharded(states, problem: CSProblem, config: SolverConfig, mesh: Mesh) -> SolveResult:
    """The whole solve loop plus the finalize collectives."""
    while _any_live(states, frontier_live, mesh, config.max_steps):
        states = _sharded_step_counted(states, problem, config, mesh)[0]
    res = finalize_sharded(states, mesh, frontier_live)
    # Find-one mode: two shards can resolve the same job in the same round
    # (the merge lands after both local harvests), so the summed count may
    # read 2; clamp to the "0 or 1" contract.  Enumeration counts are
    # disjoint-subtree sums and add exactly.
    if not config.count_all:
        res = res._replace(sol_count=torch.clamp(res.sol_count, max=1))
    return res


def _solve_csp_sharded(states0: torch.Tensor, problem: CSProblem, config: SolverConfig,
                       mesh: Mesh) -> SolveResult:
    # Round the lane count up to a multiple of the mesh size so the lane
    # axis shards evenly; per-job state is replicated, lane state sharded.
    lanes = mesh_lanes(config.resolve_lanes(states0.shape[0]), mesh.size)
    cfg = dataclasses.replace(config, lanes=lanes)
    return _run_sharded(shard_lanes(init_frontier(states0, cfg), mesh), problem, cfg, mesh)


def solve_csp_sharded(states0, problem: CSProblem, config: SolverConfig = SolverConfig(),
                      mesh: Mesh | None = None, device=None) -> SolveResult:
    """Solve root states [J, h, w] of any CSP, lanes sharded over ``mesh``
    (default: every visible device of ``device``, which ``None`` makes
    CUDA).  The solution stays in raw problem-state form."""
    if config.step_impl == "fused":
        # As in JAX: the exact-cover kernel has solve_csp_fused_sharded.
        raise ValueError(
            "step_impl='fused' supports the Sudoku entry points only; "
            f"got a generic {type(problem).__name__} (solve_csp_fused_sharded "
            "serves the exact-cover kernel)"
        )
    mesh = mesh if mesh is not None else default_mesh(device)
    return _solve_csp_sharded(_as_tensor(states0, mesh.devices[0]), problem, config, mesh)


def solve_batch_sharded(grids, geom: Geometry, config: SolverConfig = SolverConfig(),
                        mesh: Mesh | None = None, device=None) -> SolveResult:
    """Solve int grids [J, n, n] with lanes sharded over every shard of
    ``mesh``; a fused config runs K2 on every shard
    (:func:`~.fused_sharded.solve_batch_fused_sharded`)."""
    mesh = mesh if mesh is not None else default_mesh(device)
    grids = _as_tensor(grids, mesh.devices[0])
    if config.step_impl == "fused":
        from distributed_sudoku_solver_tpu_torch.parallel.fused_sharded import (
            solve_batch_fused_sharded,
        )

        return solve_batch_fused_sharded(grids, geom, config, mesh=mesh)
    res = _solve_csp_sharded(encode_grid(grids, geom), sudoku_csp(geom, config), config, mesh)
    return _decode_solution(res)


def solve_batch_sharded_wire(packed, geom: Geometry, config: SolverConfig, mesh: Mesh
                             ) -> torch.Tensor:
    """Wire-format sharded solve (``ops.solve.solve_batch_wire``'s packed
    format); the result stays on the first local shard's device."""
    from distributed_sudoku_solver_tpu_torch.ops import wire

    dtype = torch.uint8 if wire.uses_nibbles(geom) else torch.int8
    grids = wire.unpack_grids_device(_as_tensor(packed, mesh.devices[0], dtype), geom)
    res = solve_batch_sharded(grids, geom, config, mesh=mesh)
    return wire.pack_result_device(res.solution, res.solved, res.unsat, res.nodes > 0, geom)
