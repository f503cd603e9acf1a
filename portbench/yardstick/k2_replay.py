"""A plain torch replay of one K2 dispatch, frozen, for K2's roofline.

K2 (``csrc/fused_step.cu``) advances every lane of a frontier up to
``k_steps`` rounds: propagate the lane's top board to a fixpoint, classify
it, then branch on it (push the rest, continue with the guess) or pop.  The
replay runs the same rounds on the same inputs and counts what they need:
sweeps per lane, live lane-rounds, pushes and pops.  It is copied, not
imported, from the program's plain versions, so that a later change there
cannot move the count:

* ``ops/bitmask.py``: ``popcount``, ``lowest_bit``, ``or_reduce``,
  ``once_twice_reduce``, ``to_boxes``, ``from_boxes``;
* ``ops/propagate.py``: ``propagate_sweep``, ``box_line_sweep``,
  ``box_line_one_direction``, ``_or_others``, ``propagate_per_board``;
* ``ops/cuda_step.py``: ``status_full``, ``_plain_rounds`` (without the
  solution and overflow outputs), ``fused_rounds_plain``;
* ``models/sudoku.py``: ``SudokuCSP.branch`` under ``minrem``.

Rules ``basic`` and ``extended`` and the branch rule ``minrem`` are
replayed; any other raises ``ValueError``, and the roofline then reads
nothing.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF
BIG = 2**30


def popcount(x: torch.Tensor) -> torch.Tensor:
    u = x.to(torch.int64) & _LOW32
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def lowest_bit(x: torch.Tensor) -> torch.Tensor:
    return x & (~x + 1)


def _pad_pow2(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    pow2 = 1 << (n - 1).bit_length()
    return torch.nn.functional.pad(x, (0, pow2 - n)) if pow2 != n else x


def or_reduce(x: torch.Tensor, axis: int) -> torch.Tensor:
    x = _pad_pow2(torch.movedim(x, axis, -1))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] | x[..., h:]
    return x[..., 0]


def once_twice_reduce(x: torch.Tensor, axis: int):
    x = _pad_pow2(torch.movedim(x, axis, -1))
    once, twice = x, torch.zeros_like(x)
    while once.shape[-1] > 1:
        h = once.shape[-1] // 2
        o1, o2 = once[..., :h], once[..., h:]
        once, twice = o1 | o2, twice[..., :h] | twice[..., h:] | (o1 & o2)
    return once[..., 0], twice[..., 0]


class Geo:
    """A board geometry: side ``n = box_h * box_w``."""

    def __init__(self, box_h: int, box_w: int):
        self.box_h, self.box_w = box_h, box_w
        self.n = box_h * box_w
        self.n_vboxes, self.n_hboxes = self.n // box_h, self.n // box_w
        full = (1 << self.n) - 1
        self.full_mask_i32 = full - (1 << 32) if full >= 1 << 31 else full


def to_boxes(c: torch.Tensor, g: Geo) -> torch.Tensor:
    lead = c.shape[:-2]
    x = c.reshape(*lead, g.n_vboxes, g.box_h, g.n_hboxes, g.box_w).swapaxes(-3, -2)
    return x.reshape(*lead, g.n, g.n)


def from_boxes(c: torch.Tensor, g: Geo) -> torch.Tensor:
    lead = c.shape[:-2]
    x = c.reshape(*lead, g.n_vboxes, g.n_hboxes, g.box_h, g.box_w).swapaxes(-3, -2)
    return x.reshape(*lead, g.n, g.n)


def unit_views(c: torch.Tensor, g: Geo):
    yield c, lambda x: x
    yield c.swapaxes(-1, -2), lambda x: x.swapaxes(-1, -2)
    yield to_boxes(c, g), lambda x: from_boxes(x, g)


def propagate_sweep(cand: torch.Tensor, g: Geo) -> torch.Tensor:
    single = popcount(cand) == 1
    decided = torch.where(single, cand, torch.zeros_like(cand))
    seen = torch.zeros_like(cand)
    for view, undo in unit_views(decided, g):
        seen = seen | undo(or_reduce(view, -1)[..., None].expand(view.shape))
    cand = torch.where(single, cand, cand & ~seen)
    forced = torch.zeros_like(cand)
    for view, undo in unit_views(cand, g):
        once, twice = once_twice_reduce(view, -1)
        forced = forced | undo(view & (once & ~twice)[..., None].expand(view.shape))
    return torch.where(~single & (forced != 0), forced, cand)


def _or_others(x: torch.Tensor, axis: int) -> torch.Tensor:
    once, twice = once_twice_reduce(x, axis)
    return (once.unsqueeze(axis) & ~x) | twice.unsqueeze(axis)


def box_line_one_direction(x: torch.Tensor, nv: int, bh: int, nh: int, bw: int) -> torch.Tensor:
    lead = x.shape[:-2]
    v = x.reshape(*lead, nv, bh, nh, bw)
    seg = or_reduce(v, -1)
    p_once, p_twice = once_twice_reduce(seg.swapaxes(-1, -2), -1)
    point = seg & (p_once & ~p_twice)[..., None].swapaxes(-1, -2)
    c_once, c_twice = once_twice_reduce(seg, -1)
    claim = seg & (c_once & ~c_twice)[..., None]
    kill = (_or_others(point, -1) | _or_others(claim, -2))[..., None]
    return (v & ~kill.expand(v.shape)).reshape(*lead, *x.shape[-2:])


def box_line_sweep(cand: torch.Tensor, g: Geo) -> torch.Tensor:
    single = popcount(cand) == 1
    out = box_line_one_direction(cand, g.n_vboxes, g.box_h, g.n_hboxes, g.box_w)
    out = box_line_one_direction(out.swapaxes(-1, -2), g.n_hboxes, g.box_w, g.n_vboxes,
                                 g.box_h).swapaxes(-1, -2)
    return torch.where(single, cand, out)


def one_sweep(cand: torch.Tensor, g: Geo, rules: str) -> torch.Tensor:
    nxt = propagate_sweep(cand, g)
    return box_line_sweep(nxt, g) if rules == "extended" else nxt


def propagate_per_board(cand: torch.Tensor, g: Geo, max_sweeps: int, rules: str, unroll: int):
    """Each board's fixpoint and its own sweep count: ``max(min(unroll,
    max_sweeps), min(k, max_sweeps))`` where sweep ``k`` is the board's
    first that changes nothing."""
    b = cand.shape[0]
    first_still = torch.full((b,), max_sweeps, dtype=torch.int32, device=cand.device)
    done = torch.zeros(b, dtype=torch.bool, device=cand.device)
    sweeps = 0
    while sweeps < max_sweeps and not bool(done.all()):
        nxt = one_sweep(cand, g, rules)
        still = ~(nxt != cand).flatten(1).any(1)
        sweeps += 1
        first_still = torch.where(still & ~done, sweeps, first_still)
        done = done | still
        cand = nxt
    return cand, torch.clamp(first_still, min=min(unroll, max_sweeps)).to(torch.int32)


def status_full(cand: torch.Tensor, g: Geo):
    """``(solved, contradiction)``: a decided digit twice in a unit, a cell
    with no candidate, or a unit missing a digit is a contradiction."""
    single = popcount(cand) == 1
    decided = torch.where(single, cand, torch.zeros_like(cand))
    bad = (cand == 0).flatten(-2).any(-1)
    for (view, _), (dview, _) in zip(unit_views(cand, g), unit_views(decided, g)):
        _, twice = once_twice_reduce(dview, -1)
        bad = bad | (twice != 0).any(-1) | (or_reduce(view, -1) != g.full_mask_i32).any(-1)
    return single.flatten(-2).all(-1) & ~bad, bad


def branch_minrem(cand: torch.Tensor, g: Geo):
    """The undecided cell with the fewest candidates (lowest index on a
    tie) splits into its lowest digit (the guess) and the rest."""
    n, lanes = g.n, cand.shape[0]
    pc = popcount(cand).reshape(lanes, n * n)
    cell = torch.arange(n * n, dtype=torch.int32, device=cand.device)
    key = torch.where(pc > 1, pc * (n * n) + cell, torch.full_like(pc, BIG))
    onehot = (cell[None, :] == torch.argmin(key, dim=-1)[:, None]).reshape(lanes, n, n)
    pick = lowest_bit(cand)
    return torch.where(onehot, pick, cand), torch.where(onehot, cand & ~pick, cand)


def replay(top, stack, has_top, base, count, g: Geo, rules: str = "extended",
           branch_rule: str = "minrem", max_sweeps: int = 64, k_steps: int = 8,
           count_mode: bool = False, sweep_unroll: int = 2, **_ignored) -> dict:
    """Run one dispatch's rounds on copies of its inputs and count its work:
    ``sweeps`` (summed over lanes), ``live_rounds`` (lane-rounds run),
    ``pushes``, ``pops`` and ``lanes``."""
    if rules not in ("basic", "extended"):
        raise ValueError(f"the replay has no rules {rules!r}")
    if branch_rule != "minrem":
        raise ValueError(f"the replay has no branch rule {branch_rule!r}")
    lanes, s = stack.shape[:2]
    dev = top.device
    lane_idx = torch.arange(lanes, device=dev)
    zeros_l = torch.zeros(lanes, dtype=torch.int64, device=dev)
    top = top.clone()
    stack = stack.clone()
    has = has_top.to(torch.bool).clone()
    count = count.to(torch.int64).clone()
    base = base.to(torch.int64)
    solved_f = torch.zeros(lanes, dtype=torch.bool, device=dev)
    zero_b = torch.zeros_like(top)
    live_r, sweeps, pushes, pops = (zeros_l.clone() for _ in range(4))
    for _ in range(k_steps):
        live = has
        if not bool(live.any()):
            break
        tops, lane_sweeps = propagate_per_board(
            torch.where(live[:, None, None], top, zero_b), g, max_sweeps, rules, sweep_unroll)
        live_r += live.to(torch.int64)
        sweeps += torch.where(live, lane_sweeps.to(torch.int64), zeros_l)
        slv, con = status_full(tops, g)
        top_solved, top_contra = slv & live, con & live
        solved_f = solved_f | top_solved
        undecided = live & ~top_solved & ~top_contra
        guess, rest = branch_minrem(tops, g)
        can_push = undecided & (count < s)
        slot = (base + count) % s
        cur = stack[lane_idx, slot]
        stack[lane_idx, slot] = torch.where(can_push[:, None, None], rest, cur)
        pushes += undecided.to(torch.int64)
        resolved = (top_solved | top_contra) if count_mode else top_contra
        can_pop = resolved & (count > 0)
        pops += can_pop.to(torch.int64)
        popped = stack[lane_idx, (base + count - 1) % s]
        new_top = torch.where(undecided[:, None, None], guess, tops)
        new_top = torch.where(can_pop[:, None, None], popped, new_top)
        top = torch.where(live[:, None, None], new_top, top)
        has = live & ~(resolved & ~can_pop)
        if not count_mode:
            has = has & ~top_solved
        count = count + can_push.to(torch.int64) - can_pop.to(torch.int64)
    return {
        "lanes": int(lanes),
        "sweeps": int(sweeps.sum()),
        "live_rounds": int(live_r.sum()),
        # K2's ``nodes`` counts every undecided lane-round, pushed or not.
        "pushes": int(pushes.sum()),
        "pops": int(pops.sum()),
    }


def bound(rep: dict, g: Geo, rules: str) -> tuple[float, str]:
    """The least time of the replayed dispatch, in ms, and what bounds it:
    its inputs read once and its outputs written once (the lanes' tops in and
    out, the solutions, one stack row a push or pop, eleven words of lane
    state), over the HBM peak; or its operations (sweeps and live
    lane-rounds, :mod:`.cost`) over the int32 peak (``chip_smoke.py``'s
    count in ``_k2_timing``)."""
    from portbench.yardstick import cost, peaks

    n2 = g.n * g.n
    n_bytes = (3 * rep["lanes"] * n2 + (rep["pushes"] + rep["pops"]) * n2) * 4 + 11 * rep["lanes"] * 4
    n_ops = (rep["sweeps"] * cost.sweep_ops(g.n, g.box_h, g.n_hboxes, rules)
             + rep["live_rounds"] * cost.round_ops(g.n))
    return peaks.bound_ms(n_bytes, n_ops)
