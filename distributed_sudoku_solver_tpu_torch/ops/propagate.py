"""Constraint propagation as batched bitwise tensor ops (torch).

The port of the JAX package's ``ops/propagate.py``, rule for rule:

* **elimination** (a decided cell removes its digit from its row/col/box),
* **hidden singles** (a digit with exactly one home in a unit is placed),
* ``rules='extended'`` adds box-line pointing/claiming,
* ``rules='subsets'`` further adds naked-subset eliminations,

iterated to a fixpoint.  The ``lax.while_loop`` becomes a bounded Python
loop with the same batch-global "any board changed" test and the same sweep
count.  This module is the plain version of the fixpoint kernel in
:mod:`.cuda_propagate`.  Everything works on arbitrary leading batch dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import (
    from_boxes,
    is_single,
    once_twice_reduce,
    or_reduce,
    popcount,
    to_boxes,
)

RULE_TIERS = ("basic", "extended", "subsets")


def _unit_views(cand: torch.Tensor, geom: Geometry):
    """Yield (view, undo) pairs so each unit type is a reduction over axis -1."""
    yield cand, lambda x: x
    yield torch.swapaxes(cand, -1, -2), lambda x: torch.swapaxes(x, -1, -2)
    yield to_boxes(cand, geom), lambda x: from_boxes(x, geom)


def propagate_sweep(cand: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """One propagation sweep: eliminate decided digits, then place hidden singles."""
    single = is_single(cand)
    decided = torch.where(single, cand, torch.zeros_like(cand))

    seen = torch.zeros_like(cand)
    for view, undo in _unit_views(decided, geom):
        unit_or = or_reduce(view, -1)[..., None]
        seen = seen | undo(unit_or.expand(view.shape))
    cand = torch.where(single, cand, cand & ~seen)

    forced = torch.zeros_like(cand)
    for view, undo in _unit_views(cand, geom):
        once, twice = once_twice_reduce(view, -1)
        unique = (once & ~twice)[..., None]
        forced = forced | undo(view & unique.expand(view.shape))
    return torch.where(~single & (forced != 0), forced, cand)


class BoardStatus(NamedTuple):
    solved: torch.Tensor  # bool[...]: fully decided and consistent
    contradiction: torch.Tensor  # bool[...]: provably unsatisfiable


def board_status(cand: torch.Tensor, geom: Geometry) -> BoardStatus:
    """Classify each board: solved / contradiction / (neither = undecided).

    Contradiction: an empty cell, two decided cells of a unit sharing a
    digit, or a digit with no home left in a unit.  The duplicate test is
    the JAX package's uint32 ``sum != or`` over decided masks, with the sum
    taken modulo 2**32 as uint32 addition wraps."""
    single = is_single(cand)
    decided = torch.where(single, cand, torch.zeros_like(cand))
    full = geom.full_mask

    empty_cell = (cand == 0).flatten(-2).any(-1)
    dup = torch.zeros(cand.shape[:-2], dtype=torch.bool, device=cand.device)
    uncovered = torch.zeros_like(dup)
    for view, _ in _unit_views(decided, geom):
        unit_or = or_reduce(view, -1).to(torch.int64) & 0xFFFFFFFF
        unit_sum = (view.to(torch.int64) & 0xFFFFFFFF).sum(-1) & 0xFFFFFFFF
        dup = dup | (unit_sum != unit_or).any(-1)
    for view, _ in _unit_views(cand, geom):
        unit_or = or_reduce(view, -1).to(torch.int64) & 0xFFFFFFFF
        uncovered = uncovered | (unit_or != full).any(-1)

    contradiction = empty_cell | dup | uncovered
    solved = single.flatten(-2).all(-1) & ~contradiction
    return BoardStatus(solved=solved, contradiction=contradiction)


def _one_sweep(cand: torch.Tensor, geom: Geometry, rules: str) -> torch.Tensor:
    nxt = propagate_sweep(cand, geom)
    if rules in ("extended", "subsets"):
        nxt = box_line_sweep(nxt, geom)
    if rules == "subsets":
        nxt = naked_subsets_sweep(nxt, geom)
    return nxt


def propagate(
    cand: torch.Tensor, geom: Geometry, max_sweeps: int = 64, rules: str = "basic"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sweep to a fixpoint (bounded by ``max_sweeps``); returns (cand, n_sweeps).

    The loop condition is batch-global ("any board changed"), as in the JAX
    package, and ``n_sweeps`` (an int32 0-d tensor) counts every executed
    sweep, the final unchanged one included.  The loop reads its condition
    on the host once per sweep."""
    if rules not in RULE_TIERS:
        raise ValueError(f"unknown rules {rules!r}")
    sweeps = 0
    changed = True
    while changed and sweeps < max_sweeps:
        nxt = _one_sweep(cand, geom, rules)
        changed = bool((nxt != cand).any())
        cand = nxt
        sweeps += 1
    return cand, torch.tensor(sweeps, dtype=torch.int32, device=cand.device)


def propagate_per_board(
    cand: torch.Tensor,
    geom: Geometry,
    max_sweeps: int = 64,
    rules: str = "basic",
    unroll: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixpoint of a ``[B, n, n]`` batch with each board's own sweep count.

    The masks equal :func:`propagate`'s (a sweep of a fixpoint is the
    identity).  A board's count is what a loop over that board alone runs:
    ``min(unroll, max_sweeps)`` unchecked sweeps, then checked sweeps until
    one changes nothing or ``max_sweeps`` is reached, i.e.
    ``max(min(unroll, max_sweeps), min(k, max_sweeps))`` where sweep ``k``
    is the board's first sweep that changes nothing.  The kernels converge
    per board and count this way."""
    if rules not in RULE_TIERS:
        raise ValueError(f"unknown rules {rules!r}")
    b = cand.shape[0]
    first_still = torch.full((b,), max_sweeps, dtype=torch.int32, device=cand.device)
    done = torch.zeros(b, dtype=torch.bool, device=cand.device)
    sweeps = 0
    while sweeps < max_sweeps and not bool(done.all()):
        nxt = _one_sweep(cand, geom, rules)
        still = ~(nxt != cand).flatten(1).any(1)
        sweeps += 1
        first_still = torch.where(still & ~done, sweeps, first_still)
        done = done | still
        cand = nxt
    floor = min(unroll, max_sweeps)
    return cand, torch.clamp(first_still, min=floor).to(torch.int32)


def box_line_sweep(cand: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Pointing/claiming reductions (box-line interactions), bit-parallel.

    Rows direction first, then the columns direction on its result (with the
    transposed box layout), then decided cells restored to their input."""
    single = is_single(cand)
    nv, nh, bh, bw = geom.n_vboxes, geom.n_hboxes, geom.box_h, geom.box_w
    out = box_line_one_direction(cand, nv, bh, nh, bw)
    out_t = box_line_one_direction(torch.swapaxes(out, -1, -2), nh, bw, nv, bh)
    out = torch.swapaxes(out_t, -1, -2)
    return torch.where(single, cand, out)


def box_line_one_direction(
    x: torch.Tensor, nv: int, bh: int, nh: int, bw: int
) -> torch.Tensor:
    """Rows direction of the box-line rules on x[..., nv*bh, nh*bw]."""
    lead = x.shape[:-2]
    v = x.reshape(*lead, nv, bh, nh, bw)
    seg = or_reduce(v, -1)  # [..., v, r, h]

    p_once, p_twice = once_twice_reduce(torch.swapaxes(seg, -1, -2), -1)
    point = seg & torch.swapaxes((p_once & ~p_twice)[..., None], -1, -2)
    point_other = _or_others(point, -1)

    c_once, c_twice = once_twice_reduce(seg, -1)
    claim = seg & (c_once & ~c_twice)[..., None]
    claim_other = _or_others(claim, -2)

    kill = (point_other | claim_other)[..., None]
    return (v & ~kill.expand(v.shape)).reshape(*lead, *x.shape[-2:])


def naked_subsets_sweep(cand: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Naked-subset eliminations in every unit, all subset sizes at once.

    For a cell with mask ``m`` (``k`` bits): if at least ``k`` nonzero cells
    of the unit are subsets of ``m``, ``m``'s bits leave every other cell of
    the unit (and every cell, exposing the contradiction, when more than
    ``k`` are)."""
    single = is_single(cand)
    kill = torch.zeros_like(cand)
    for view, undo in _unit_views(cand, geom):
        kill = kill | undo(_naked_subset_kill(view))
    return torch.where(single, cand, cand & ~kill)


def _naked_subset_kill(view: torch.Tensor) -> torch.Tensor:
    """Per-cell kill mask of the naked-subset rule on unit view [..., U, C]."""
    m = view[..., :, None]
    x = view[..., None, :]
    sub = ((x & ~m) == 0) & (x != 0)
    cnt = sub.to(torch.int32).sum(-1)  # [..., U, C_i]
    k = popcount(view)
    confined = (view != 0) & (cnt >= k)
    over = (cnt > k)[..., None]
    hit = confined[..., None] & (~sub | over)
    masked = torch.where(hit, m.expand(hit.shape), torch.zeros_like(hit, dtype=view.dtype))
    return or_reduce(masked, -2)


def _or_others(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Per slot along ``axis``: the OR of every *other* slot's bits."""
    once, twice = once_twice_reduce(x, axis)
    once = torch.unsqueeze(once, axis)
    twice = torch.unsqueeze(twice, axis)
    return (once & ~x) | twice
