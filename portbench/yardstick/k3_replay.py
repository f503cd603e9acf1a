"""A plain torch replay of one K3 dispatch, frozen, for K3's roofline.

K3 (``csrc/cover.cu``) advances every lane of an exact-cover frontier up to
``k_steps`` rounds: take the unique row of the lowest one-row column until
none is left (the fixpoint), classify the state, then branch on the column
with the fewest rows (push the rest, continue with the guess) or pop.  The
replay runs the same rounds on the same inputs and counts what their data
needs.  It is copied, not imported, from the program and its smoke, so that
a later change there cannot move the count:

* ``ops/bitmask.py``: ``_i32``, ``popcount``, ``clz``, ``lowest_bit``;
* ``models/cover.py``: ``ExactCoverCSP._counts``, ``_lowest_row``,
  ``_take_row``, ``_row_bit``, ``_forced_take``, ``_fixpoint``, ``status``,
  ``branch``;
* ``ops/cuda_step.py``: ``_plain_rounds`` (without the tile clear);
* ``chip_smoke.py``: ``cover_dispatch_work``'s tallies, ``cover_dispatch_ops``
  and ``_cols_per_row``, and phase 8's byte count.

The instance is read from the program's instance object as data: its
packed arrays ``col_rows``, ``row_cols``, ``elim`` and ``incidence`` and
their sizes.
"""

from __future__ import annotations

import numpy as np
import torch

_LOW32 = 0xFFFFFFFF
BIG = 2**30


def _u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _LOW32


def _i32(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    u = _u64(x)
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def clz(x: torch.Tensor) -> torch.Tensor:
    u = _u64(x)
    for s in (1, 2, 4, 8, 16):
        u = u | (u >> s)
    return 32 - popcount(_i32(u))


def lowest_bit(x: torch.Tensor) -> torch.Tensor:
    return x & (~x + 1)


def _unpack(words: np.ndarray, k: int) -> np.ndarray:
    """uint32 words [..., W] -> bool [..., k], bit b of word w at 32 w + b."""
    b = (np.asarray(words, dtype=np.uint32)[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return b.reshape(*b.shape[:-2], -1)[..., :k].astype(bool)


class Instance:
    """One exact-cover instance's arrays as int32 tensors on ``device``,
    from the program's instance ``problem``."""

    def __init__(self, problem, device):
        def dev(a):
            words = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
            return torch.from_numpy(words).to(device)

        self.n_rows, self.n_primary = int(problem.n_rows), int(problem.n_primary)
        self.n_cols_full = int(problem.n_cols_full)
        self.col_rows, self.row_cols, self.elim = (dev(problem.col_rows), dev(problem.row_cols),
                                                   dev(problem.elim))
        self.w_rows, self.w_cols = self.elim.shape[1], self.row_cols.shape[1]
        inc = _unpack(problem.incidence, self.n_cols_full)
        per_row = inc.sum(1)
        self.cols_per_row = float(per_row.mean())
        # The kernel's row list: each row's columns, padded to the most a
        # row has, rounded up to an even count (ExactCoverCSP.row_list).
        self.row_list_size = self.n_rows * max(2, -(-int(per_row.max()) // 2) * 2)
        self.primary_per_row = torch.from_numpy(
            inc[:, : self.n_primary].sum(1).astype(np.int64)).to(device)
        c_idx = np.arange(self.n_primary)
        self.c_idx = torch.arange(self.n_primary, dtype=torch.int32, device=device)
        self.word = torch.from_numpy(c_idx // 32).to(device)
        self.bit = torch.from_numpy((c_idx % 32).astype(np.int32)).to(device)
        self.shifts = torch.arange(32, dtype=torch.int32, device=device)

    def split(self, states):
        flat = states[..., 0, :]
        return flat[..., : self.w_rows], flat[..., self.w_rows:]

    @staticmethod
    def join(avail, covered):
        return torch.cat([avail, covered], dim=-1)[..., None, :]

    def uncovered(self, covered):
        return ((covered[:, self.word] >> self.bit) & 1) == 0

    def counts(self, avail, covered):
        cnt = popcount(avail[:, None, :] & self.col_rows[None]).sum(-1, dtype=torch.int32)
        return cnt, self.uncovered(covered)

    @staticmethod
    def lowest_row(rowmask):
        first_w = torch.argmax((rowmask != 0).to(torch.int32), dim=-1)
        word = rowmask.gather(-1, first_w[:, None])[:, 0]
        return first_w.to(torch.int32) * 32 + (31 - clz(lowest_bit(word)))

    def take_row(self, avail, covered, row, active):
        r = torch.clamp(row, 0, self.n_rows - 1).long()
        return (torch.where(active[:, None], avail & ~self.elim[r], avail),
                torch.where(active[:, None], covered | self.row_cols[r], covered))

    def row_bit(self, row):
        r = torch.clamp(row, 0, self.n_rows - 1).to(torch.int64)
        w_idx = torch.arange(self.w_rows, dtype=torch.int64, device=row.device)
        bit = _i32(torch.ones_like(r) << (r % 32))
        return torch.where(w_idx[None, :] == (r // 32)[:, None], bit[:, None],
                           torch.zeros((), dtype=torch.int32, device=row.device))

    def forced_take(self, avail, covered):
        cnt, unc = self.counts(avail, covered)
        forced = unc & (cnt == 1)
        has = forced.any(-1)
        col = torch.argmin(torch.where(forced, self.c_idx[None], BIG), dim=-1)
        row = self.lowest_row(self.col_rows[col] & avail)
        avail, covered = self.take_row(avail, covered, row, has)
        return avail, covered, has

    def status(self, states):
        cnt, unc = self.counts(*self.split(states))
        contradiction = (unc & (cnt == 0)).any(-1)
        return ~unc.any(-1) & ~contradiction, contradiction

    def branch(self, states):
        avail, covered = self.split(states)
        cnt, unc = self.counts(avail, covered)
        branchable = unc & (cnt >= 1)
        key = torch.where(branchable, cnt * self.n_primary + self.c_idx[None], BIG)
        row = self.lowest_row(self.col_rows[torch.argmin(key, dim=-1)] & avail)
        active = branchable.any(-1)
        g_avail, g_covered = self.take_row(avail, covered, row, active)
        r_avail = torch.where(active[:, None], avail & ~self.row_bit(row), avail)
        return self.join(g_avail, g_covered), self.join(r_avail, covered)

    def killed_primary(self, before, after):
        """Per lane: the primary columns of the rows that left ``before``."""
        gone = (before & ~after)[:, :, None] >> self.shifts & 1
        return (gone.flatten(1)[:, : self.n_rows].to(torch.int64) * self.primary_per_row).sum(1)


def _fixpoint(inst: Instance, states, max_sweeps: int, fresh, work: dict):
    """The lanes' fixpoints and each lane's own sweeps, tallying the work:
    ``loaded`` (uncovered columns of the ``fresh`` lanes' states, whose
    counts start from scratch), ``columns`` (uncovered columns of every
    search pass: each sweep and the re-scan after a chain the cap cut),
    ``takes`` and ``decrements`` (primary columns of the rows each take
    killed)."""
    avail, covered = inst.split(states)
    active = (states != 0).flatten(1).any(1)
    work["loaded"] += int((inst.uncovered(covered) & (active & fresh)[:, None]).sum())
    lane_sweeps = torch.zeros(active.shape[0], dtype=torch.int32, device=states.device)
    for _ in range(max_sweeps):
        work["sweeps"] += int(active.sum())
        lane_sweeps += active.to(torch.int32)
        work["columns"] += int((inst.uncovered(covered) & active[:, None]).sum())
        after, covered, took = inst.forced_take(avail, covered)
        active = active & took
        work["takes"] += int(active.sum())
        work["decrements"] += int(inst.killed_primary(avail, after)[active].sum())
        avail = after
        if not bool(active.any()):
            break
    work["columns"] += int((inst.uncovered(covered) & active[:, None]).sum())
    return inst.join(avail, covered), lane_sweeps


def rounds(top, stack, has_top, base, count, problem, max_sweeps: int = 64, k_steps: int = 8,
           count_mode: bool = False, **_ignored):
    """One dispatch's rounds on copies of its inputs.  Returns the lane
    state after them (``stack``, ``has``, ``count``, ``solved``, ``sol``,
    ``overflow``, ``nodes``, ``sols``, ``live_rounds``, ``sweeps``; the top
    without the kernel's tile clear) and ``work``: ``sweeps``, ``columns``,
    ``loaded``, ``takes``, ``decrements``, ``nodes`` (undecided lane-rounds,
    a push each), ``pops``, ``live_rounds`` and ``lanes``."""
    inst = problem if isinstance(problem, Instance) else Instance(problem, top.device)
    lanes, s = stack.shape[:2]
    dev = top.device
    lane_idx = torch.arange(lanes, dtype=torch.int64, device=dev)
    zeros_l = torch.zeros(lanes, dtype=torch.int32, device=dev)
    top, stack = top.clone(), stack.clone()
    has = has_top.to(torch.bool).clone()
    count = count.to(torch.int32).clone()
    base = base.to(torch.int32).clone()
    sol, zero_b = torch.zeros_like(top), torch.zeros_like(top)
    solved_f = torch.zeros(lanes, dtype=torch.bool, device=dev)
    over_f = torch.zeros_like(solved_f)
    nodes, sols, live_r, sweeps = (zeros_l.clone() for _ in range(4))
    undecided = torch.zeros_like(solved_f)
    work = {"sweeps": 0, "columns": 0, "loaded": 0, "takes": 0, "decrements": 0, "pops": 0}
    for _ in range(k_steps):
        live = has
        if not bool(live.any()):
            break
        tops, lane_sweeps = _fixpoint(inst, torch.where(live[:, None, None], top, zero_b),
                                      max_sweeps, ~undecided, work)
        live_r += live.to(torch.int32)
        sweeps += torch.where(live, lane_sweeps, zeros_l)
        slv, con = inst.status(tops)
        top_solved, top_contra = slv & live, con & live
        newly = top_solved & ~solved_f
        sol = torch.where(newly[:, None, None], tops, sol)
        solved_f = solved_f | newly
        if count_mode:
            sols += top_solved.to(torch.int32)
        undecided = live & ~top_solved & ~top_contra
        guess, rest = inst.branch(tops)
        work["decrements"] += int(inst.killed_primary(inst.split(tops)[0],
                                                      inst.split(guess)[0])[undecided].sum())
        can_push = undecided & (count < s)
        slot = ((base + count) % s).long()
        stack[lane_idx, slot] = torch.where(can_push[:, None, None], rest, stack[lane_idx, slot])
        over_f = over_f | (undecided & ~can_push)
        nodes += undecided.to(torch.int32)
        resolved = (top_solved | top_contra) if count_mode else top_contra
        can_pop = resolved & (count > 0)
        work["pops"] += int(can_pop.sum())
        popped = stack[lane_idx, ((base + count - 1) % s).long()]
        new_top = torch.where(undecided[:, None, None], guess, tops)
        new_top = torch.where(can_pop[:, None, None], popped, new_top)
        top = torch.where(live[:, None, None], new_top, top)
        has = live & ~(resolved & ~can_pop)
        if not count_mode:
            has = has & ~top_solved
        count = count + can_push.to(torch.int32) - can_pop.to(torch.int32)
    work.update(nodes=int(nodes.sum()), live_rounds=int(live_r.sum()), lanes=int(lanes))
    state = {"top": top, "stack": stack, "has": has, "count": count, "solved": solved_f,
             "sol": sol, "overflow": over_f, "nodes": nodes, "sols": sols,
             "live_rounds": live_r, "sweeps": int(sweeps.sum())}
    return state, work


def dispatch_ops(inst: Instance, work: dict) -> float:
    """Integer operations of one dispatch on its data, with the column
    counts kept from pass to pass: per uncovered column of a loaded state,
    AND, popcount and add per row word; per uncovered column of a search
    pass, one compare; one decrement per primary column of a killed row;
    per row taken (forced, or a branch's guess), the lowest row (2 per row
    word), the take (one OR per row word per column of the row, 2 per row
    word to clear and keep, 1 per covered word); 1 per word of each state
    the stack pushes or pops."""
    wr, wc = inst.w_rows, inst.w_cols
    take = 2 * wr + (inst.cols_per_row + 2) * wr + wc
    copies = work["nodes"] + work["pops"]
    return (work["loaded"] * 3 * wr + work["columns"] + work["decrements"]
            + (work["takes"] + work["nodes"]) * take + copies * (wr + wc))


def dispatch_bytes(inst: Instance, work: dict) -> int:
    """Bytes of one dispatch, each read or written once: the lanes' states
    in and out and the solutions, one stack row a push or pop, the column
    masks and row lists, and eleven words of lane state."""
    d = inst.w_rows + inst.w_cols
    consts = inst.n_cols_full * inst.w_rows + inst.row_list_size
    return ((3 * work["lanes"] * d + (work["nodes"] + work["pops"]) * d + consts) * 4
            + 11 * work["lanes"] * 4)


def bound(inst: Instance, work: dict) -> tuple[float, str]:
    """The least time of the replayed dispatch, in ms, and what bounds it
    (``yardstick/peaks.bound_ms``)."""
    from portbench.yardstick import peaks

    return peaks.bound_ms(dispatch_bytes(inst, work), dispatch_ops(inst, work))
