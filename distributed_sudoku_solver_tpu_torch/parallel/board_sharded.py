"""Board-sharded solving: one board's rows banded over the shards of a mesh.

Port of the JAX package's ``parallel/board_sharded.py``, the
sequence-parallel axis of the system.  The lane-sharded path
(:mod:`.sharded`) scales the number of search states over shards; this
module splits the problem dimension itself: each shard owns a horizontal
band of every board, and each propagation sweep exchanges per-column
candidate aggregates with the other shards around a ring.

Layout, chosen so that exactly one of the three unit families crosses
shards:

* the rows are grouped into box bands of ``box_h`` rows, padded up to a
  multiple of the mesh size and dealt contiguously, ``bands_per_chip`` to
  a shard, so row and box units live inside one shard;
* only column units span shards: their OR and once-twice aggregates are
  reduced with an explicit ring (:func:`ring_or`, :func:`ring_once_twice`,
  D-1 ``ppermute`` hops of an ``[L, n]`` tile).

The lane-stack engine (``ops.frontier.run_frontier``) runs unchanged on
the whole board; :class:`BandedSudoku`'s ``propagate`` / ``status`` /
``branch`` cut the boards into their bands, compute each band's part on
its shard's device and exchange the column aggregates over the ring, and
every verdict the engine reads is the all-reduced one, so results
(solutions, node counts, branch order, sweeps) are bit-identical to the
single-device solver.  The engine's own state (lane bookkeeping, tops and
stacks) stays whole on the first shard's device: the JAX package shards
the stack's rows too, which a one-controller port would keep on every
card as row bands; on one card the two hold the same memory.

Pad rows hold the empty mask 0: they add the identity to every aggregate,
are never branch candidates, and are masked out of the status checks.
This module runs no kernel and rejects ``propagator='pallas'``, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.ops.bitmask import (
    decode_grid,
    encode_grid,
    is_single,
    lowest_bit,
    once_twice_reduce,
    or_reduce,
    popcount,
)
from distributed_sudoku_solver_tpu_torch.ops.frontier import (
    SolverConfig,
    init_frontier,
    run_frontier,
)
from distributed_sudoku_solver_tpu_torch.ops.propagate import (
    RULE_TIERS,
    _naked_subset_kill,
    _or_others,
    box_line_one_direction,
)
from distributed_sudoku_solver_tpu_torch.ops.solve import (
    SolveResult,
    _as_tensor,
    finalize_frontier,
)
from distributed_sudoku_solver_tpu_torch.parallel import collectives as C
from distributed_sudoku_solver_tpu_torch.parallel.mesh import Mesh, make_mesh

# Mesh axis the board's row-band dimension is sharded over.
BAND_AXIS = "bands"


def make_band_mesh(devices=None, device=None) -> Mesh:
    """A 1-D mesh whose axis shards board row bands."""
    return make_mesh(devices, axis_name=BAND_AXIS, device=device)


# -- ring all-reduces: the neighbour-exchange loop -------------------------------


def ring_or(xs, mesh: Mesh) -> list:
    """Bitwise-OR all-reduce over the shards in D-1 ring hops: each hop
    forwards the accumulated tile to the successor."""
    acc, buf = list(xs), list(xs)
    perm = C.ring_forward(mesh.size)
    for _ in range(mesh.size - 1):
        buf = C.ppermute(buf, perm, mesh)
        acc = [a | b for a, b in zip(acc, buf)]
    return acc


def ring_once_twice(onces, twices, mesh: Mesh) -> tuple[list, list]:
    """All-reduce per-shard (once, twice) column aggregates around the ring
    with the combiner ((o1,t1),(o2,t2)) -> (o1|o2, t1|t2|(o1&o2)), which is
    associative and commutative, so the result is the exact global one."""
    acc_o, acc_t = list(onces), list(twices)
    buf_o, buf_t = list(onces), list(twices)
    perm = C.ring_forward(mesh.size)
    for _ in range(mesh.size - 1):
        buf_o = C.ppermute(buf_o, perm, mesh)
        buf_t = C.ppermute(buf_t, perm, mesh)
        acc_t = [t | bt | (o & bo) for o, t, bo, bt in zip(acc_o, acc_t, buf_o, buf_t)]
        acc_o = [o | bo for o, bo in zip(acc_o, buf_o)]
    return acc_o, acc_t


def _psum_any(xs, mesh: Mesh) -> list:
    """Logical-OR all-reduce of bool arrays."""
    return [x > 0 for x in C.psum([x.to(torch.int32) for x in xs], mesh)]


# -- the banded problem ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandedSudoku:
    """Sudoku CSP whose propagate / status / branch run band by band.

    The engine hands it whole (row-padded) states ``int32[L, rows_padded,
    n]``; each method cuts them into the shards' bands and reduces the
    column units over the ring.  Branch order matches ``SudokuCSP``'s
    (same key, global row-major cell index), so searches are bit-identical
    to the unsharded engine."""

    geom: Geometry
    mesh: Mesh
    bands_per_chip: int
    branch_rule: str = "minrem"
    max_sweeps: int = 64
    rules: str = "basic"

    @property
    def n_dev(self) -> int:
        return self.mesh.size

    @property
    def rows_local(self) -> int:
        return self.bands_per_chip * self.geom.box_h

    @property
    def rows_padded(self) -> int:
        return self.rows_local * self.n_dev

    @property
    def state_shape(self) -> tuple[int, int]:
        return (self.rows_padded, self.geom.n)

    # -- bands ------------------------------------------------------------

    def _split(self, x: torch.Tensor) -> list:
        rl = self.rows_local
        return [x[..., i * rl:(i + 1) * rl, :].to(d) for i, d in enumerate(self.mesh.devices)]

    def _join(self, parts) -> torch.Tensor:
        d0 = self.mesh.devices[0]
        return torch.cat([p.to(d0) for p in parts], dim=-2)

    def _to_boxes(self, x: torch.Tensor) -> torch.Tensor:
        """[..., rows_local, n] -> [..., local boxes, box cells]."""
        g = self.geom
        lead = x.shape[:-2]
        x = x.reshape(*lead, self.bands_per_chip, g.box_h, g.n_hboxes, g.box_w)
        x = torch.swapaxes(x, -3, -2)
        return x.reshape(*lead, self.bands_per_chip * g.n_hboxes, g.n)

    def _from_boxes(self, x: torch.Tensor) -> torch.Tensor:
        g = self.geom
        lead = x.shape[:-2]
        x = x.reshape(*lead, self.bands_per_chip, g.n_hboxes, g.box_h, g.box_w)
        x = torch.swapaxes(x, -3, -2)
        return x.reshape(*lead, self.rows_local, g.n)

    def _row_valid(self, i: int, device) -> torch.Tensor:
        """bool[rows_local]: which of shard i's rows are real board rows."""
        grow = i * self.rows_local + torch.arange(self.rows_local, dtype=torch.int32,
                                                  device=device)
        return grow < self.geom.n

    def _box_valid(self, i: int, device) -> torch.Tensor:
        """bool[local boxes]: shard i's boxes in real (non-pad) bands."""
        g = self.geom
        band = i * self.bands_per_chip + torch.div(
            torch.arange(self.bands_per_chip * g.n_hboxes, dtype=torch.int32, device=device),
            g.n_hboxes, rounding_mode="floor")
        return band < g.n_vboxes

    # -- propagation ------------------------------------------------------

    def _sweep(self, cands: list) -> list:
        """One sweep of ``ops/propagate.py``'s rules, columns ring-reduced."""
        n = self.geom.n
        singles = [is_single(c) for c in cands]
        decided = [torch.where(s, c, torch.zeros_like(c)) for s, c in zip(singles, cands)]

        # Elimination: decided digits leave their row and box (local) and
        # their column (one ring OR).
        col_or = ring_or([or_reduce(d, -2) for d in decided], self.mesh)
        out = []
        for c, s, d, co in zip(cands, singles, decided, col_or):
            row_or = or_reduce(d, -1)[..., None]
            box_or = or_reduce(self._to_boxes(d), -1)[..., None]
            box_seen = self._from_boxes(box_or.expand(*box_or.shape[:-1], n))
            seen = row_or | box_seen | co[..., None, :]
            out.append(torch.where(s, c, c & ~seen))
        cands = out

        # Hidden singles: a digit with one home in a unit is placed.
        parts = [once_twice_reduce(c, -2) for c in cands]
        c_once, c_twice = ring_once_twice([p[0] for p in parts], [p[1] for p in parts],
                                          self.mesh)
        out = []
        for c, s, co, ct in zip(cands, singles, c_once, c_twice):
            forced = torch.zeros_like(c)
            r_once, r_twice = once_twice_reduce(c, -1)
            forced = forced | (c & (r_once & ~r_twice)[..., None])
            boxes = self._to_boxes(c)
            b_once, b_twice = once_twice_reduce(boxes, -1)
            b_unique = (b_once & ~b_twice)[..., None]
            forced = forced | self._from_boxes(boxes & b_unique.expand(boxes.shape))
            forced = forced | (c & (co & ~ct)[..., None, :])
            out.append(torch.where(~s & (forced != 0), forced, c))
        cands = out
        if self.rules in ("extended", "subsets"):
            cands = self._box_line(cands)
        if self.rules == "subsets":
            cands = self._naked_subsets(cands)
        return cands

    def _naked_subsets(self, cands: list) -> list:
        """Banded naked subsets: rows and boxes are shard-local; columns ride
        one all_gather over the band axis (the subset test depends on each
        probe, which no fixed-size associative reduce expresses), and the
        unsharded kill runs on the gathered view.  Pad rows hold 0, which
        the rule ignores on both sides, so the result stays bit-exact."""
        gathered = C.all_gather(cands, self.mesh, axis=-2, tiled=True)
        rl = self.rows_local
        out = []
        for i, (c, g) in enumerate(zip(cands, gathered)):
            single = is_single(c)
            kill = _naked_subset_kill(c) | self._from_boxes(_naked_subset_kill(self._to_boxes(c)))
            col_kill = torch.swapaxes(_naked_subset_kill(torch.swapaxes(g, -1, -2)), -1, -2)
            kill = kill | col_kill[..., i * rl:(i + 1) * rl, :]
            out.append(torch.where(single, c, c & ~kill))
        return out

    def _box_line(self, cands: list) -> list:
        """Banded pointing / claiming: the rows direction is shard-local, the
        columns direction's cross-band aggregates ride the ring, with
        ``OR_{b' != b} x[b'] == (once & ~x[b]) | twice`` for the other bands."""
        g = self.geom
        rows = [box_line_one_direction(c, self.bands_per_chip, g.box_h, g.n_hboxes, g.box_w)
                for c in cands]
        cols = self._box_line_cols(rows)
        return [torch.where(is_single(c), c, o) for c, o in zip(cands, cols)]

    def _box_line_cols(self, xs: list) -> list:
        """Columns direction: roles (nv,bh,nh,bw) -> (nh,bw,nv,bh), with the
        nv (band) axis sharded over the mesh."""
        g = self.geom
        nh, bw, bh = g.n_hboxes, g.box_w, g.box_h
        n_b = self.bands_per_chip
        vs, segs, points, l_parts, s_parts = [], [], [], [], []
        for x in xs:
            lead = x.shape[:-2]
            v = torch.swapaxes(x, -1, -2).reshape(*lead, nh, bw, n_b, bh)
            seg = or_reduce(v, -1)  # [L, nh, bw, B]: column segment per band
            p_once, p_twice = once_twice_reduce(torch.swapaxes(seg, -1, -2), -1)
            point = seg & torch.swapaxes((p_once & ~p_twice)[..., None], -1, -2)
            vs.append(v)
            segs.append(seg)
            points.append(point)
            l_parts.append(once_twice_reduce(point, -1))
            s_parts.append(once_twice_reduce(seg, -1))
        g_once, g_twice = ring_once_twice([p[0] for p in l_parts], [p[1] for p in l_parts],
                                          self.mesh)
        gs_once, gs_twice = ring_once_twice([p[0] for p in s_parts], [p[1] for p in s_parts],
                                            self.mesh)
        out = []
        for v, seg, point, go, gt, so, st in zip(vs, segs, points, g_once, g_twice, gs_once,
                                                 gs_twice):
            point_other = (go[..., None] & ~point) | gt[..., None]
            claim = seg & (so & ~st)[..., None]
            claim_other = _or_others(claim, -2)
            kill = (point_other | claim_other)[..., None]
            o = v & ~kill.expand(v.shape)
            out.append(torch.swapaxes(o.reshape(*v.shape[:-4], g.n, self.rows_local), -1, -2))
        return out

    def propagate(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Sweep to a fixpoint; the "changed" flag is all-reduced, so every
        shard runs the same number of ring exchanges.  One host read of it
        per sweep, as ``ops.propagate.propagate``."""
        cur = self._split(states)
        sweeps = 0
        changed = True
        while changed and sweeps < self.max_sweeps:
            nxt = self._sweep(cur)
            changed = bool(_psum_any([(a != b).any() for a, b in zip(nxt, cur)], self.mesh)[0])
            cur = nxt
            sweeps += 1
        return self._join(cur), torch.tensor(sweeps, dtype=torch.int32,
                                             device=self.mesh.devices[0])

    # -- classification ---------------------------------------------------

    def status(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(solved, contradiction) per lane: ``ops.propagate.board_status``'s
        rules with row and box checks on each shard's valid units, column
        checks from the ring aggregates, verdicts OR-merged."""
        full = self.geom.full_mask_i32
        parts = self._split(states)
        singles = [is_single(s) for s in parts]
        decided = [torch.where(si, s, torch.zeros_like(s)) for si, s in zip(singles, parts)]
        cd = [once_twice_reduce(d, -2) for d in decided]
        _, cd_twice = ring_once_twice([p[0] for p in cd], [p[1] for p in cd], self.mesh)
        col_or = ring_or([or_reduce(s, -2) for s in parts], self.mesh)
        local_bad, undecided = [], []
        for i, (s, si, d) in enumerate(zip(parts, singles, decided)):
            rv = self._row_valid(i, s.device)[:, None]
            bv = self._box_valid(i, s.device)
            empty = ((s == 0) & rv).flatten(-2).any(-1)
            _, rd_twice = once_twice_reduce(d, -1)
            dup = ((rd_twice != 0) & rv[..., 0]).any(-1)
            unc = ((or_reduce(s, -1) != full) & rv[..., 0]).any(-1)
            _, bd_twice = once_twice_reduce(self._to_boxes(d), -1)
            dup = dup | ((bd_twice != 0) & bv).any(-1)
            unc = unc | ((or_reduce(self._to_boxes(s), -1) != full) & bv).any(-1)
            local_bad.append(empty | dup | unc)
            undecided.append((~si & rv).flatten(-2).any(-1))
        col_bad = (cd_twice[0] != 0).any(-1) | (col_or[0] != full).any(-1)
        contradiction = _psum_any(local_bad, self.mesh)[0] | col_bad
        solved = ~_psum_any(undecided, self.mesh)[0] & ~contradiction
        return solved, contradiction

    # -- branching --------------------------------------------------------

    def branch(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Lowest digit vs the rest at the globally chosen cell: each shard
        finds its best (key, global cell) packed scalar, a ``pmin`` picks
        the winner, and only the owning shard's band changes.  The key is
        ``SudokuCSP``'s (MRV, or first undecided, global row-major tie-break)."""
        g = self.geom
        parts = self._split(states)
        n_lanes = states.shape[0]
        n_cells = self.rows_padded * g.n
        big = 2**30
        gcells, local_mins = [], []
        for i, s in enumerate(parts):
            pc = popcount(s).to(torch.int32)
            gcell = i * self.rows_local * g.n + torch.arange(
                self.rows_local * g.n, dtype=torch.int32, device=s.device
            ).reshape(self.rows_local, g.n)
            undecided = pc > 1  # pad rows have pc == 0, never chosen
            key = pc * n_cells + gcell if self.branch_rule == "minrem" else gcell.expand_as(pc)
            key = torch.where(undecided, key, torch.full_like(pc, big))
            gcells.append(gcell)
            local_mins.append(key.reshape(n_lanes, -1).amin(-1))
        gmin = C.pmin(local_mins, self.mesh)
        guesses, rests = [], []
        for s, gcell, gm in zip(parts, gcells, gmin):
            chosen = gm % n_cells
            onehot = (gcell[None] == chosen[:, None, None]) & (gm[:, None, None] < big)
            low = lowest_bit(s)
            guesses.append(torch.where(onehot, low, s))
            rests.append(torch.where(onehot, s & ~low, s))
        return self._join(guesses), self._join(rests)

    def signature(self) -> str:
        return (
            f"banded-sudoku:{self.geom.box_h}x{self.geom.box_w}"
            f":{self.n_dev}x{self.bands_per_chip}:{self.branch_rule}"
            f":{self.max_sweeps}:{self.rules}"
        )


# -- driver ----------------------------------------------------------------------


def validate_banded_config(config: SolverConfig) -> None:
    """Reject solver options the banded path cannot honour, loudly: the
    banded ``pmin`` key implements exactly the two total orders a
    cross-shard argmin reproduces, and the banded sweep has its own ring
    exchanges, so the fixpoint kernel does not apply."""
    if config.rules not in RULE_TIERS:
        raise ValueError(f"unknown rules {config.rules!r}")
    if config.branch not in ("minrem", "first"):
        raise ValueError(
            f"board-sharded solve supports branch='minrem'|'first', "
            f"got {config.branch!r} ('mixed'/'minrem-desc' and the "
            f"'head:*' scored rules are batch-path features)"
        )
    if config.propagator != "xla":
        raise ValueError(
            f"board-sharded solve supports propagator='xla' only, "
            f"got {config.propagator!r}"
        )


def _banded_problem(geom: Geometry, config: SolverConfig, mesh: Mesh) -> BandedSudoku:
    validate_banded_config(config)
    return BandedSudoku(
        geom=geom, mesh=mesh, bands_per_chip=-(-geom.n_vboxes // mesh.size),
        branch_rule=config.branch, max_sweeps=config.max_sweeps, rules=config.rules,
    )


def solve_batch_banded(grids, geom: Geometry, config: SolverConfig = SolverConfig(),
                       mesh: Mesh | None = None, device=None) -> SolveResult:
    """Solve int grids [J, n, n] with each board's rows banded over ``mesh``
    (default: every visible device of ``device``, which ``None`` makes CUDA).

    The board-parallel counterpart of ``solve_batch_sharded``: that one
    scales over many jobs, this one when one board must span shards.
    Results are bit-identical to the single-device ``solve_batch``."""
    validate_banded_config(config)
    mesh = mesh if mesh is not None else make_band_mesh(device=device)
    grids = _as_tensor(grids, mesh.devices[0])
    problem = _banded_problem(geom, config, mesh)
    cand = encode_grid(grids, geom)
    cand = torch.nn.functional.pad(cand, (0, 0, 0, problem.rows_padded - geom.n))
    state = run_frontier(init_frontier(cand, config), problem, config)
    res = finalize_frontier(state)
    sol = res.solution[:, :geom.n, :]  # strip pad rows
    solution = torch.where(res.solved[:, None, None], decode_grid(sol), torch.zeros_like(sol))
    return res._replace(solution=solution)
