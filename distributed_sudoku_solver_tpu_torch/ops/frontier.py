"""The lane-stack frontier: per-lane DFS stacks, work stealing, cancellation.

Port of the JAX package's ``ops/frontier.py``: the batch solve, the
flight operations that serving runs between chunks (seed, attach, detach,
purge, shed) and the latency-mode megastep.  Each of L lanes owns a
working state ``top[L, h, w]`` and a circular stack ``stack[L, S, h, w]``
of deferred siblings; every round each live lane propagates its top, then
branches (guess becomes the top, rest is pushed) or pops on a
contradiction, and idle lanes steal the bottom row of a working lane.

Layout and semantics are the JAX package's, lane-first.  Its
``.at[...].set/min/add(mode='drop')`` scatters with an out-of-range
sentinel index become scatters into a tensor one row longer whose last row
is dropped, so no step needs a host sync for compaction.  The loops that
JAX runs in-graph (``lax.while_loop``) are Python loops here: one host
sync per round reads the loop condition, and the megastep's chunk loop
reads its condition once per chunk (JAX syncs once per flight).

:func:`frontier_step` writes the pushed rows into ``state.stack`` in place
(the JAX advance functions donate the state for the same reason): the
stack is the frontier's one large tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.ops import ordering
from distributed_sudoku_solver_tpu_torch.ops.csp import CSProblem

# Frontier rounds per fused-kernel dispatch, per surface (the JAX package's
# names and values, so a config means the same in both packages).
FUSED_STEPS_DEVICE = 32  # device-resident surfaces: batch solves, bulk rungs
FUSED_STEPS_LINKED = 8  # per-chunk transfer surfaces: the bulk first pass


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration: the JAX package's fields and values.

    ``propagator='pallas'`` selects the hand-written fixpoint kernel and
    ``step_impl='fused'`` the hand-written round kernel.  ``branch`` takes
    the legacy rules and the scored heads ``head:minrem``,
    ``head:cw-slack`` and ``head:mlp`` (:mod:`.ordering`).
    """

    lanes: int = 0
    min_lanes: int = 64
    stack_slots: int = 64
    max_steps: int = 100_000
    max_sweeps: int = 64
    branch: str = "minrem"
    rules: str = "basic"
    propagator: str = "xla"
    branch_k: int = 2
    count_all: bool = False
    step_impl: str = "xla"
    fused_steps: int | None = None
    fused_sweep_unroll: int = 2
    steal: bool = True
    steal_rounds: int = 1
    steal_gang: int = 0
    ring_steal_k: int = 8
    protect_home_lanes: bool = False

    def __post_init__(self) -> None:
        ordering.validate_branch(self.branch)
        if self.branch_k not in (2, 3):
            raise ValueError(f"branch_k must be 2 or 3, got {self.branch_k}")
        if self.step_impl not in ("xla", "fused"):
            raise ValueError(f"unknown step_impl {self.step_impl!r}")
        if self.step_impl == "fused" and self.branch_k != 2:
            raise ValueError("step_impl='fused' supports branch_k=2 only")
        if self.fused_steps is not None and self.fused_steps < 1:
            raise ValueError(f"fused_steps must be >= 1, got {self.fused_steps}")
        if self.fused_sweep_unroll < 0:
            raise ValueError(
                f"fused_sweep_unroll must be >= 0, got {self.fused_sweep_unroll}"
            )
        if self.steal_gang < 0:
            raise ValueError(f"steal_gang must be >= 0, got {self.steal_gang}")

    @classmethod
    def from_fields(cls, fields: Any) -> "SolverConfig":
        """Build from the JAX package's ``SolverConfig`` (or a mapping of
        its fields): the two dataclasses share every field and value."""
        if dataclasses.is_dataclass(fields):
            fields = dataclasses.asdict(fields)
        return cls(**dict(fields))

    def with_fused_steps(self, surface_default: int) -> "SolverConfig":
        """Resolve ``fused_steps=None`` to the calling surface's default."""
        if self.fused_steps is not None:
            return self
        return dataclasses.replace(self, fused_steps=surface_default)

    def resolve_lanes(self, n_jobs: int) -> int:
        lanes = self.lanes if self.lanes > 0 else max(n_jobs, self.min_lanes)
        if lanes < n_jobs:
            raise ValueError(f"lanes={lanes} < n_jobs={n_jobs}")
        return lanes

    def resolve_lanes_packed(self, n_roots: int) -> int:
        """Lane count :func:`init_frontier_packed` uses for ``n_roots``
        round-robin-dealt rows."""
        if self.lanes > 0:
            return self.lanes
        return max(self.min_lanes, -(-n_roots // (1 + self.stack_slots)))


class Frontier(NamedTuple):
    """Loop-carried device state for one solve call (the JAX fields)."""

    top: torch.Tensor  # int32[L, h, w] working state per lane
    has_top: torch.Tensor  # bool[L]
    stack: torch.Tensor  # int32[L, S, h, w] deferred siblings (circular)
    base: torch.Tensor  # int32[L] bottom slot of the circular stack
    count: torch.Tensor  # int32[L] deferred rows on the stack
    job: torch.Tensor  # int32[L] owning job; -1 = unassigned
    solved: torch.Tensor  # bool[J]
    solution: torch.Tensor  # int32[J, h, w]
    overflowed: torch.Tensor  # bool[J]
    nodes: torch.Tensor  # int32[J]
    sol_count: torch.Tensor  # int32[J]
    steps: torch.Tensor  # int32 0-d
    sweeps: torch.Tensor  # int32 0-d
    expansions: torch.Tensor  # int32 0-d
    steals: torch.Tensor  # int32 0-d
    lane_rounds: torch.Tensor  # int32[L] rounds each lane was live


# -- numpy interchange with the JAX package ------------------------------------

_MASK_FIELDS = ("top", "stack", "solution")
_BOARDS_LAST = {"top_t": ("top", (2, 0, 1)), "stack_t": ("stack", (3, 0, 1, 2)),
                "solution_t": ("solution", (2, 0, 1))}


def _field_dict(state: Any) -> dict:
    if hasattr(state, "_asdict"):
        return dict(state._asdict())
    return dict(state)


def frontier_from_numpy(state: Any, device="cpu") -> Frontier:
    """A JAX frontier, lane-first or in its fused driver's boards-last form
    (numpy arrays or anything ``np.asarray`` takes; a NamedTuple or a
    mapping) -> the port's ``Frontier``.

    uint32 masks become int32 tensors with the same bits; the boards-last
    ``top_t`` / ``stack_t`` / ``solution_t`` are transposed to the
    lane-first ``top`` / ``stack`` / ``solution``."""
    out = {}
    for k, v in _field_dict(state).items():
        a = np.asarray(v)
        if k in _BOARDS_LAST:
            k, perm = _BOARDS_LAST[k]
            a = a.transpose(perm)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.array(a, order="C", copy=True)).to(device)
    return Frontier(**out)


def frontier_to_numpy(state: Frontier) -> dict:
    """The port's ``Frontier`` -> a dict of numpy arrays in the JAX
    package's ``Frontier`` layout (uint32 masks)."""
    out = {}
    for k, v in state._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in _MASK_FIELDS else a
    return out


# -- seeding --------------------------------------------------------------------


def _seed_inverse(n_roots: int, n_lanes: int, device):
    """Inverse of the strided seed map floor(r * L / R): ``(root_of,
    is_seed, safe_root)`` per lane (sentinel ``n_roots`` = unseeded)."""
    seed_lane = (np.arange(n_roots, dtype=np.int64) * n_lanes) // n_roots
    root_of_np = np.full(n_lanes, n_roots, np.int64)
    root_of_np[seed_lane] = np.arange(n_roots)
    root_of = torch.from_numpy(root_of_np.astype(np.int32)).to(device)
    is_seed = torch.from_numpy(root_of_np < n_roots).to(device)
    safe_root = torch.clamp(root_of, 0, max(n_roots - 1, 0))
    return root_of, is_seed, safe_root


def _new_frontier(top, has_top, job, stack, count, n_jobs: int) -> Frontier:
    """A frontier at step 0 over seeded lanes, with fresh job rows."""
    n_lanes, h, w = top.shape
    dev = top.device
    i32 = dict(dtype=torch.int32, device=dev)
    zero = torch.zeros((), **i32)
    return Frontier(
        top=top,
        has_top=has_top,
        stack=stack,
        base=torch.zeros(n_lanes, **i32),
        count=count,
        job=job,
        solved=torch.zeros(n_jobs, dtype=torch.bool, device=dev),
        solution=torch.zeros((n_jobs, h, w), **i32),
        overflowed=torch.zeros(n_jobs, dtype=torch.bool, device=dev),
        nodes=torch.zeros(n_jobs, **i32),
        sol_count=torch.zeros(n_jobs, **i32),
        steps=zero.clone(),
        sweeps=zero.clone(),
        expansions=zero.clone(),
        steals=zero.clone(),
        lane_rounds=torch.zeros(n_lanes, **i32),
    )


def init_frontier(states0: torch.Tensor, config: SolverConfig) -> Frontier:
    """Seed each job's root state into its own lane, strided over the lanes
    (lane floor(j*L/J)); extra lanes start idle, as thieves."""
    n_jobs, h, w = states0.shape
    dev = states0.device
    n_lanes = config.resolve_lanes(n_jobs)
    root_of, is_seed, safe_root = _seed_inverse(n_jobs, n_lanes, dev)
    rows = states0.to(torch.int32)[safe_root.long()]
    top = torch.where(is_seed[:, None, None], rows, torch.zeros_like(rows))
    return _new_frontier(
        top, is_seed, torch.where(is_seed, root_of, torch.full_like(root_of, -1)),
        torch.zeros((n_lanes, config.stack_slots, h, w), dtype=torch.int32, device=dev),
        torch.zeros(n_lanes, dtype=torch.int32, device=dev), n_jobs,
    )


# -- flight operations: seed, attach, detach, purge, shed -----------------------


def init_frontier_roots(
    roots: torch.Tensor, job_of_root: torch.Tensor, n_jobs: int, config: SolverConfig
) -> Frontier:
    """Seed a frontier from R root states, each tagged with its owning job
    (``job_of_root`` -1 = padding: the lane stays idle), strided over the
    lanes as :func:`init_frontier` seeds them."""
    n_roots, h, w = roots.shape
    dev = roots.device
    n_lanes = config.resolve_lanes(n_roots)
    _, seeded, safe_root = _seed_inverse(n_roots, n_lanes, dev)
    job_of = job_of_root.to(device=dev, dtype=torch.int32)[safe_root.long()]
    is_seed = seeded & (job_of >= 0)
    rows = roots.to(torch.int32)[safe_root.long()]
    return _new_frontier(
        torch.where(is_seed[:, None, None], rows, torch.zeros_like(rows)), is_seed,
        torch.where(is_seed, job_of, torch.full_like(job_of, -1)),
        torch.zeros((n_lanes, config.stack_slots, h, w), dtype=torch.int32, device=dev),
        torch.zeros(n_lanes, dtype=torch.int32, device=dev), n_jobs,
    )


def init_frontier_packed(roots: torch.Tensor, valid, config: SolverConfig) -> Frontier:
    """Seed ONE job's subtree roots at the configured lane width: row r
    lands on lane ``r % L``, the first as the lane's top, the rest pushed
    onto its stack (slot ``r // L - 1``).  ``valid`` masks padding rows,
    which must come last."""
    n_roots, h, w = roots.shape
    s = config.stack_slots
    dev = roots.device
    n_lanes = config.resolve_lanes_packed(n_roots)
    if n_roots > n_lanes * (1 + s):
        raise ValueError(f"{n_roots} roots exceed frontier capacity {n_lanes}x(1+{s})")
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    rows = roots.to(torch.int32)

    def seeds(r):  # the root at each grid position, and whether it is real
        safe = torch.from_numpy(np.minimum(r, n_roots - 1)).to(dev)
        exists = torch.from_numpy(r < n_roots).to(dev)
        return rows[safe], exists & valid[safe]

    r_top = np.arange(n_lanes)
    top_rows, is_top = seeds(r_top)
    st_rows, is_stack = seeds(r_top[:, None] + (np.arange(s)[None, :] + 1) * n_lanes)
    return _new_frontier(
        torch.where(is_top[:, None, None], top_rows, torch.zeros_like(top_rows)), is_top,
        is_top.to(torch.int32) - 1,  # job 0 on a seeded lane, else -1
        torch.where(is_stack[:, :, None, None], st_rows, torch.zeros_like(st_rows)),
        is_stack.sum(1, dtype=torch.int32), 1,
    )


def purge_jobs(state: Frontier, dead: torch.Tensor) -> Frontier:
    """Clear every lane owned by a job in ``dead`` (bool[J]), the mid-flight
    cancel; purged unsolved jobs are marked overflowed, so they finalize
    as unknown, never as unsat."""
    n_jobs = state.solved.shape[0]
    lane_dead = (state.job >= 0) & dead[torch.clamp(state.job, 0, n_jobs - 1).long()]
    return state._replace(
        has_top=state.has_top & ~lane_dead,
        count=torch.where(lane_dead, torch.zeros_like(state.count), state.count),
        overflowed=state.overflowed | (dead & ~state.solved),
    )


def attach_roots(state: Frontier, roots: torch.Tensor, slot_ids: torch.Tensor,
                 gang: int = 1) -> Frontier:
    """Seed up to K newly admitted jobs into a live frontier: root k lands
    on its slot's home lane ``slot_ids[k] * gang`` (slot -1 = padding row,
    dropped), and the slot's job rows are reset."""
    n_lanes = state.has_top.shape[0]
    n_jobs = state.solved.shape[0]
    slot_ids = slot_ids.to(torch.int32)
    ok = slot_ids >= 0
    lane = torch.where(ok, slot_ids * gang, n_lanes)
    slot = torch.where(ok, slot_ids, n_jobs)
    return state._replace(
        top=_set_rows(state.top, lane, roots.to(torch.int32)),
        has_top=_set_rows(state.has_top, lane, ok),
        job=_set_rows(state.job, lane, slot_ids),
        base=_set_rows(state.base, lane, 0),
        count=_set_rows(state.count, lane, 0),
        solved=_set_rows(state.solved, slot, False),
        solution=_set_rows(state.solution, slot, 0),
        overflowed=_set_rows(state.overflowed, slot, False),
        nodes=_set_rows(state.nodes, slot, 0),
        sol_count=_set_rows(state.sol_count, slot, 0),
    )


def detach(state: Frontier, slot_mask: torch.Tensor) -> Frontier:
    """Free every lane and job row of the jobs in ``slot_mask`` (bool[J])
    after their verdicts were read: lanes cleared and untagged, rows reset
    to their initial state."""
    n_jobs = state.solved.shape[0]
    lane_dead = (state.job >= 0) & slot_mask[torch.clamp(state.job, 0, n_jobs - 1).long()]
    keep = ~slot_mask
    return state._replace(
        has_top=state.has_top & ~lane_dead,
        count=torch.where(lane_dead, torch.zeros_like(state.count), state.count),
        job=torch.where(lane_dead, torch.full_like(state.job, -1), state.job),
        solved=state.solved & keep,
        solution=torch.where(slot_mask[:, None, None], torch.zeros_like(state.solution),
                             state.solution),
        overflowed=state.overflowed & keep,
        nodes=torch.where(slot_mask, torch.zeros_like(state.nodes), state.nodes),
        sol_count=torch.where(slot_mask, torch.zeros_like(state.sol_count), state.sol_count),
    )


def shed_rows(state: Frontier, job_id, k: int):
    """Extract up to ``k`` bottom stack rows of ``job_id`` (one per donor
    lane, a bottom-pointer bump as in :func:`_steal`) for work elsewhere.
    Returns ``(new_state, rows int32[k, h, w], valid bool[k])``; with
    ``k`` above the lane count no row ships twice."""
    n_lanes, s = state.stack.shape[:2]
    n_jobs = state.solved.shape[0]
    dev = state.job.device
    job_live = (state.job == job_id) & ~state.solved[torch.clamp(state.job, 0, n_jobs - 1).long()]
    donor_of = _lane_by_rank(job_live & (state.count >= 1), n_lanes)
    idx = torch.arange(k, dtype=torch.int32, device=dev)
    donor_lane = donor_of[torch.clamp(idx, 0, n_lanes - 1).long()]  # n_lanes if absent
    valid = (idx < n_lanes) & (donor_lane < n_lanes)
    safe = torch.clamp(donor_lane, 0, n_lanes - 1).long()
    rows = state.stack[safe, (state.base[safe] % s).long()]
    rows = torch.where(valid[:, None, None], rows, torch.zeros_like(rows))
    donor_sel = _set_rows(torch.zeros(n_lanes, dtype=torch.bool, device=dev),
                          torch.where(valid, donor_lane, n_lanes), True)
    new_state = state._replace(
        base=torch.where(donor_sel, (state.base + 1) % s, state.base),
        count=torch.where(donor_sel, state.count - 1, state.count),
    )
    return new_state, rows, valid


# -- scatters with a dropped sentinel row ---------------------------------------


def _scatter_min(size: int, fill: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """int32[size]: per index the min of ``vals`` (``fill`` where none);
    entries with index ``size`` are dropped."""
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=vals.device)
    out.scatter_reduce_(0, idx.long(), vals.to(torch.int32), "amin")
    return out[:size]


def _scatter_add(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.cat([base, base.new_zeros(1)])
    out.scatter_add_(0, idx.long(), vals.to(base.dtype))
    return out[:-1]


def _set_rows(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``base.at[idx].set(vals, mode='drop')``: rows of ``idx`` outside
    ``[0, len(base))`` are dropped (routed to a spare last row).  A scalar
    ``vals`` is filled on the device: an index write of a Python scalar
    would copy it from the host and synchronise."""
    size = base.shape[0]
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((), vals, dtype=base.dtype, device=base.device)
    out = torch.cat([base, base.new_zeros((1, *base.shape[1:]))])
    out[torch.where((idx >= 0) & (idx < size), idx, size).long()] = vals
    return out[:size]


def _scatter_max_bool(size: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(size + 1, dtype=torch.int32, device=vals.device)
    out.scatter_reduce_(0, idx.long(), vals.to(torch.int32), "amax")
    return out[:size] > 0


# -- work stealing --------------------------------------------------------------


def _lane_by_rank(mask: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """int32[..., L]: lane of the r-th True entry along the last axis
    (``n_lanes`` where r >= the number of True entries)."""
    rank = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32) - 1
    rank = torch.where(mask, rank, torch.full_like(rank, n_lanes))
    lead = mask.shape[:-1]
    out = torch.full((*lead, n_lanes + 1), n_lanes, dtype=torch.int32, device=mask.device)
    lanes = torch.arange(n_lanes, dtype=torch.int32, device=mask.device).expand(*lead, n_lanes)
    out.scatter_(-1, rank.long(), lanes)
    return out[..., :n_lanes]


def pair_thieves_donors(idle: torch.Tensor, donor: torch.Tensor, n_lanes: int, gang: int = 0):
    """Rank-match idle lanes with donor lanes.

    Returns ``(thief_lane, donor_lane, pair, n_pairs)`` on the rank axis:
    entry r pairs the r-th idle lane with the r-th donor lane; unmatched
    ranks carry ``n_lanes``.  ``gang > 0`` matches within consecutive
    ``gang``-lane blocks only."""
    dev = idle.device
    if gang > 0:
        if n_lanes % gang:
            raise ValueError(f"steal_gang={gang} does not divide lanes={n_lanes}")
        n_gangs = n_lanes // gang
        idle2 = idle.reshape(n_gangs, gang)
        donor2 = donor.reshape(n_gangs, gang)
        thief_of = _lane_by_rank(idle2, gang)
        donor_of = _lane_by_rank(donor2, gang)
        pairs_g = torch.minimum(
            idle2.sum(1, dtype=torch.int32), donor2.sum(1, dtype=torch.int32)
        )
        rank_in_gang = torch.arange(gang, dtype=torch.int32, device=dev)[None, :]
        pair2 = rank_in_gang < pairs_g[:, None]
        offs = (torch.arange(n_gangs, dtype=torch.int32, device=dev) * gang)[:, None]
        sentinel = torch.full_like(thief_of, n_lanes)
        thief_lane = torch.where(pair2, thief_of + offs, sentinel).reshape(-1)
        donor_lane = torch.where(pair2, donor_of + offs, sentinel).reshape(-1)
        return thief_lane, donor_lane, pair2.reshape(-1), pairs_g.sum(dtype=torch.int32)
    lane_idx = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    n_pairs = torch.minimum(idle.sum(dtype=torch.int32), donor.sum(dtype=torch.int32))
    pair = lane_idx < n_pairs
    sentinel = torch.full_like(lane_idx, n_lanes)
    thief_lane = torch.where(pair, _lane_by_rank(idle, n_lanes), sentinel)
    donor_lane = torch.where(pair, _lane_by_rank(donor, n_lanes), sentinel)
    return thief_lane, donor_lane, pair, n_pairs


def _steal(top, has_top, stack, base, count, job, job_live, gang: int = 0, thief_ok=None):
    """Match idle lanes with working lanes; hand each thief a donor's
    *bottom* row and bump the donor's bottom pointer.  Gather-formulated:
    every lane looks up the donor it steals from (none: ``L``)."""
    n_lanes, s = stack.shape[:2]
    dev = has_top.device
    idle = ~has_top if thief_ok is None else (~has_top & thief_ok)
    donor = has_top & (count >= 1) & job_live
    thief_lane, donor_lane, pair, n_pairs = pair_thieves_donors(idle, donor, n_lanes, gang)

    src = torch.full((n_lanes + 1,), n_lanes, dtype=torch.int32, device=dev)
    src.scatter_(0, thief_lane.long(), donor_lane)
    src = src[:n_lanes]
    stole = src < n_lanes
    safe = torch.clamp(src, 0, n_lanes - 1).long()
    stolen = stack[safe, (base[safe] % s).long()]
    top = torch.where(stole[:, None, None], stolen, top)
    has_top = has_top | stole
    job = torch.where(stole, job[safe], job)

    donor_sel = _set_rows(torch.zeros(n_lanes, dtype=torch.bool, device=dev),
                          torch.where(pair, donor_lane, n_lanes), True)
    base = torch.where(donor_sel, (base + 1) % s, base)
    count = torch.where(donor_sel, count - 1, count)
    return top, has_top, base, count, job, n_pairs


def _write_rows(stack, lane_idx, slot, mask, rows):
    """stack[l, slot[l]] = rows[l] where mask[l], one row per lane, in place."""
    li, si = lane_idx.long(), slot.long()
    cur = stack[li, si]
    stack[li, si] = torch.where(mask[:, None, None], rows, cur)
    return stack


# -- the round ------------------------------------------------------------------


def frontier_step(state: Frontier, problem: CSProblem, config: SolverConfig) -> Frontier:
    """One lockstep round: propagate tops -> harvest/cancel -> branch/pop -> steal."""
    n_lanes, s = state.stack.shape[:2]
    n_jobs = state.solved.shape[0]
    dev = state.has_top.device
    lane_idx = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    zero_l = torch.zeros_like(lane_idx)
    sentinel_j = torch.full_like(lane_idx, n_jobs)

    job_safe = torch.clamp(state.job, 0, n_jobs - 1).long()
    job_live = (state.job >= 0) & ~state.solved[job_safe]
    live = state.has_top & job_live
    count = torch.where(job_live, state.count, zero_l)

    tops = torch.where(live[:, None, None], state.top, torch.zeros_like(state.top))
    tops, sweeps = problem.propagate(tops)
    top_solved, top_contra = problem.status(tops)
    solved_tops = top_solved & live
    contra_tops = top_contra & live
    undecided = live & ~solved_tops & ~contra_tops

    scatter_job = torch.where(solved_tops, state.job, sentinel_j)
    first = _scatter_min(
        n_jobs, n_lanes, scatter_job,
        torch.where(solved_tops, lane_idx, torch.full_like(lane_idx, n_lanes)),
    )
    had_sol = state.sol_count > 0
    newly = (first < n_lanes) & ~state.solved & ~had_sol
    sol_rows = tops[torch.clamp(first, 0, n_lanes - 1).long()]
    solution = torch.where(newly[:, None, None], sol_rows, state.solution)
    if config.count_all:
        sol_count = _scatter_add(state.sol_count, scatter_job, solved_tops.to(torch.int32))
        solved = state.solved
    else:
        sol_count = state.sol_count + newly.to(torch.int32)
        solved = state.solved | newly

    if config.branch_k == 3 and not hasattr(problem, "branch3"):
        raise ValueError(
            f"branch_k=3 requires the problem to implement branch3; "
            f"{type(problem).__name__} does not"
        )
    stack = state.stack
    if config.branch_k == 3:
        guess, second, rest3, has_rest3 = problem.branch3(tops)
        push_a = undecided & has_rest3 & (count < s)
        stack = _write_rows(stack, lane_idx, (state.base + count) % s, push_a, rest3)
        count_a = count + push_a.to(torch.int32)
        push_b = undecided & (count_a < s)
        stack = _write_rows(stack, lane_idx, (state.base + count_a) % s, push_b, second)
        can_push = push_b
        count = count_a
        overflow_now = undecided & (~push_b | (has_rest3 & ~push_a))
    else:
        guess, rest = problem.branch(tops)
        can_push = undecided & (count < s)
        stack = _write_rows(stack, lane_idx, (state.base + count) % s, can_push, rest)
        overflow_now = undecided & ~can_push
    overflowed = _set_rows(
        state.overflowed, torch.where(overflow_now, state.job, sentinel_j), True
    )
    nodes = _scatter_add(
        state.nodes, torch.where(undecided, state.job, sentinel_j), undecided.to(torch.int32)
    )

    resolved = solved_tops | contra_tops
    can_pop = resolved & (count > 0)
    pop_slot = (state.base + count - 1) % s
    popped = stack[lane_idx.long(), pop_slot.long()]

    top = torch.where(undecided[:, None, None], guess, state.top)
    top = torch.where(can_pop[:, None, None], popped, top)
    has_top = state.has_top & job_live & ~(resolved & ~can_pop)
    count = count + can_push.to(torch.int32) - can_pop.to(torch.int32)

    job_live = (state.job >= 0) & ~solved[job_safe]
    has_top = has_top & job_live
    count = torch.where(job_live, count, zero_l)
    base = state.base
    n_steals = torch.zeros((), dtype=torch.int32, device=dev)
    job_arr = state.job
    if config.steal:
        thief_ok = None
        if config.protect_home_lanes and config.steal_gang > 0:
            thief_ok = (lane_idx % config.steal_gang) != 0
        for _ in range(max(1, config.steal_rounds)):
            top, has_top, base, count, job_arr, k = _steal(
                top, has_top, stack, base, count, job_arr, job_live,
                gang=config.steal_gang, thief_ok=thief_ok,
            )
            job_live = (job_arr >= 0) & ~solved[torch.clamp(job_arr, 0, n_jobs - 1).long()]
            n_steals = n_steals + k

    return Frontier(
        top=top,
        has_top=has_top,
        stack=stack,
        base=base,
        count=count,
        job=job_arr,
        solved=solved,
        solution=solution,
        overflowed=overflowed,
        nodes=nodes,
        sol_count=sol_count,
        steps=state.steps + 1,
        sweeps=state.sweeps + sweeps,
        expansions=state.expansions + undecided.sum(dtype=torch.int32),
        steals=state.steals + n_steals,
        lane_rounds=state.lane_rounds + live.to(torch.int32),
    )


def frontier_live(state) -> torch.Tensor:
    """bool[L]: lanes still holding unexplored work for an unsolved job."""
    n_jobs = state.solved.shape[0]
    job_safe = torch.clamp(state.job, 0, n_jobs - 1).long()
    return state.has_top & (state.job >= 0) & ~state.solved[job_safe]


def run_frontier(
    state: Frontier,
    problem: CSProblem,
    config: SolverConfig,
    step_limit: int | torch.Tensor | None = None,
) -> Frontier:
    """Drive steps until every job resolves or ``steps`` reaches the limit
    (``config.max_steps`` at most).  One host sync per round reads the loop
    condition; both limits are compared on the device, so a tensor
    ``step_limit`` is never read by the host on its own."""
    limit = config.max_steps if step_limit is None else step_limit
    while bool(frontier_live(state).any() & (state.steps < limit)
               & (state.steps < config.max_steps)):
        state = frontier_step(state, problem, config)
    return state


# -- packed chunk status (layout of the JAX package's chunk_status) -------------

STATUS_STEPS = 0
STATUS_LIVE_SUM = 1
STATUS_HIST = 2
STATUS_BITS = 12


def status_len(n_jobs: int) -> int:
    return STATUS_BITS + 2 * ((n_jobs + 31) // 32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[J] -> int32[ceil(J/32)], bit b of word w = job 32*w + b."""
    j = bits.shape[0]
    w = (j + 31) // 32
    padded = torch.nn.functional.pad(bits.to(torch.int64), (0, w * 32 - j))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(w, 32) << shifts).sum(1)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def chunk_status(prev_steps, prev_lane_rounds: torch.Tensor, new) -> torch.Tensor:
    """int32[status_len(J)]: steps, live-rounds sum, occupancy decile
    histogram, solved bits, has-work bits (see the JAX package)."""
    n_jobs = new.solved.shape[0]
    live = frontier_live(new)
    job_safe = torch.clamp(new.job, 0, n_jobs - 1)
    has_work = _scatter_max_bool(n_jobs, job_safe, live)
    delta = new.lane_rounds - prev_lane_rounds
    steps_delta = torch.clamp(new.steps - prev_steps, min=1)
    bucket = torch.clamp(torch.div(delta * 10, steps_delta, rounding_mode="floor"), 0, 9)
    hist = torch.zeros(10, dtype=torch.int32, device=delta.device)
    hist.scatter_add_(0, bucket.long(), torch.ones_like(bucket))
    head = torch.stack([new.steps.to(torch.int32), delta.sum(dtype=torch.int32)])
    return torch.cat([head, hist, _pack_bits(new.solved), _pack_bits(has_work)])


def unpack_status(status, n_jobs: int) -> dict:
    """Host-side inverse of :func:`chunk_status` (numpy)."""
    if isinstance(status, torch.Tensor):
        status = status.cpu().numpy()
    status = np.asarray(status)
    w = (n_jobs + 31) // 32

    def bits(words):
        return (
            ((words.astype(np.int64)[:, None] >> np.arange(32)) & 1)
            .astype(bool)
            .reshape(-1)[:n_jobs]
        )

    return {
        "steps": int(status[STATUS_STEPS]),
        "live_sum": int(status[STATUS_LIVE_SUM]),
        "hist": status[STATUS_HIST:STATUS_BITS].astype(np.int64),
        "solved": bits(status[STATUS_BITS : STATUS_BITS + w]),
        "has_work": bits(status[STATUS_BITS + w : STATUS_BITS + 2 * w]),
    }


# -- latency-mode megastep --------------------------------------------------------


def megastep_chunks(state, advance, chunk_steps: int, max_chunks: int, max_steps: int):
    """The megastep's chunk loop, shared by the composite and fused forms.

    ``advance(state, limit)`` runs rounds until nothing is live or
    ``steps`` reaches ``limit``.  Every chunk's status is taken against
    the flight-start baselines; the loop stops when no job has work, after
    ``max_chunks`` chunks, or at ``max_steps``.  The host reads the steps
    once, then the condition (has-work and steps, one transfer) once per
    chunk.  Returns ``(state, status, chunks)``, ``chunks`` a host int."""
    n_jobs = state.solved.shape[0]
    w = (n_jobs + 31) // 32
    steps0, rounds0 = state.steps, state.lane_rounds

    def one_chunk(st, steps: int):
        new = advance(st, min(steps + int(chunk_steps), max_steps))
        return new, chunk_status(steps0, rounds0, new)

    st, status = one_chunk(state, int(state.steps))
    chunks = 1
    while chunks < int(max_chunks):
        alive = status[STATUS_BITS + w : STATUS_BITS + 2 * w].ne(0).any()
        alive, steps = torch.stack([alive.to(torch.int32), st.steps]).tolist()
        if not (alive and steps < max_steps):
            break
        st, status = one_chunk(st, steps)
        chunks += 1
    return st, status, chunks


def run_frontier_megastep(state: Frontier, problem: CSProblem, config: SolverConfig,
                          chunk_steps: int, max_chunks: int):
    """Advance in chunks of ``chunk_steps`` rounds until every job is
    solved or exhausted, ``max_chunks`` chunks ran, or ``config.max_steps``.

    Returns ``(new_state, status, chunks)``: ``status`` is the packed word of
    :func:`chunk_status` against the flight-start ``steps`` /
    ``lane_rounds``, ``chunks`` how many chunks ran (>= 1), as in JAX
    (here a host int: the host counted them)."""
    return megastep_chunks(
        state, lambda st, limit: run_frontier(st, problem, config, step_limit=limit),
        chunk_steps, max_chunks, config.max_steps,
    )


def advance_megastep(state: Frontier, chunk_steps: int, max_chunks: int, geom,
                     config: SolverConfig):
    """One latency-mode flight of the composite step on Sudoku (the entry
    point ``serving/megastep.py`` drives).  The stack is updated in place:
    callers rebind the returned state."""
    from distributed_sudoku_solver_tpu_torch.ops.solve import sudoku_csp

    return run_frontier_megastep(state, sudoku_csp(geom, config), config, chunk_steps,
                                 max_chunks)
