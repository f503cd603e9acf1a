"""Generalized exact cover as a CSProblem: the engine's second problem family.

Port of the JAX package's ``models/cover.py``.  Choose a subset of ROWS
such that every PRIMARY column is covered exactly once and every SECONDARY
column at most once (the dancing-links problem, as tensors).  A search
state packs two bit vectors into one ``int32[1, D]`` tensor of uint32 bit
patterns, ``D = W_r + W_c``:

* ``avail`` (W_r words over R rows): rows not conflicting with the current
  partial selection.  Chosen rows stay available, so at a solved state
  ``avail`` is exactly the chosen-row set (the decode invariant).
* ``covered`` (W_c words over the primary columns): columns covered so far.
  Secondary columns live only in the row-conflict matrix ``elim``.

``propagate`` takes the unique row of a one-candidate column (lowest such
column first, one take per lane per sweep) to a fixpoint, ``status`` reads
"all primary covered" / "an uncovered column has no row", and ``branch``
splits on the MRV column: take its lowest available row vs exclude it.

The instance arrays are kept as the same uint32 numpy arrays as in the JAX
package and hashed over the same bytes, so :meth:`ExactCoverCSP.signature`
strings match across the two packages (:func:`cover_from_numpy` carries an
instance across).  Torch copies of the arrays are made once per device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.ops.bitmask import _i32, clz, lowest_bit, popcount

_BIG = 2**30


def _pack_bits(a: np.ndarray) -> np.ndarray:
    """bool[..., K] -> uint32[..., ceil(K/32)], bit b of word w = index w*32+b."""
    a = np.asarray(a, dtype=bool)
    k = a.shape[-1]
    w = -(-k // 32) if k else 1
    pad = [(0, 0)] * (a.ndim - 1) + [(0, w * 32 - k)]
    a = np.pad(a, pad)
    a = a.reshape(*a.shape[:-1], w, 32)
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (a.astype(np.uint64) * weights).sum(-1).astype(np.uint32)


def _as_u32(packed) -> np.ndarray:
    """Packed words (numpy of any integer type, or a torch tensor of int32
    bit patterns) -> uint32 numpy with the same bits."""
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    packed = np.asarray(packed)
    if packed.dtype == np.int32:
        return packed.view(np.uint32)
    return packed.astype(np.uint32)


def _unpack_bits(packed, k: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits` (host-side, for decoding solutions)."""
    packed = _as_u32(packed)
    bits = (packed[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :k].astype(bool)


@dataclasses.dataclass(frozen=True, eq=False)
class ExactCoverCSP:
    """One generalized-exact-cover instance (hashable by content digest)."""

    name: str
    n_rows: int
    n_primary: int
    col_rows: np.ndarray  # uint32[C, W_r]: rows covering each primary column
    row_cols: np.ndarray  # uint32[R, W_c]: primary columns covered by each row
    elim: np.ndarray  # uint32[R, W_r]: rows conflicting with row r (r excluded)
    max_sweeps: int = 64
    # Full incidence (primary + secondary columns), bit-packed [R, ceil(Cf/32)];
    # the composite methods never read it, the round kernel K3 does.
    incidence: Optional[np.ndarray] = None
    n_cols_full: int = 0

    def __post_init__(self) -> None:
        h = hashlib.sha256()
        for arr in (self.col_rows, self.row_cols, self.elim):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(f"{self.name}:{self.n_rows}:{self.n_primary}:{self.max_sweeps}".encode())
        if self.incidence is not None:
            h.update(np.ascontiguousarray(self.incidence).tobytes())
            h.update(str(self.n_cols_full).encode())
        object.__setattr__(self, "_digest", h.hexdigest())
        object.__setattr__(self, "_on_device", {})

    def __hash__(self) -> int:
        return hash(self._digest)

    def __eq__(self, other) -> bool:
        return isinstance(other, ExactCoverCSP) and self._digest == other._digest

    # -- geometry ------------------------------------------------------------
    @property
    def w_rows(self) -> int:
        return self.elim.shape[1]

    @property
    def w_cols(self) -> int:
        return self.row_cols.shape[1]

    @property
    def state_shape(self) -> tuple[int, int]:
        return (1, self.w_rows + self.w_cols)

    def signature(self) -> str:
        return f"cover:{self.name}:{self._digest[:16]}"

    def _tensors(self, device: torch.device) -> dict:
        """int32 torch copies of the instance arrays on ``device`` (made once).

        With the full incidence they include the round kernel's constants:
        ``col_rows_full`` [C_full + 1, W_r] (rows of every column, primary
        first, then a zero row for padding entries) and ``row_list``
        (:meth:`row_list`, padded with rows of -1 to 32 * W_r rows)."""
        key = str(device)
        t = self._on_device.get(key)
        if t is None:
            c_idx = np.arange(self.n_primary)

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

            t = {
                "col_rows": dev(self.col_rows),
                "row_cols": dev(self.row_cols),
                "elim": dev(self.elim),
                "c_idx": torch.arange(self.n_primary, dtype=torch.int32, device=device),
                "word": torch.from_numpy(c_idx // 32).to(device),
                "bit": torch.from_numpy((c_idx % 32).astype(np.int32)).to(device),
            }
            if self.incidence is not None:
                inc = _unpack_bits(self.incidence, self.n_cols_full)
                masks = _pack_bits(inc.T)
                t["col_rows_full"] = dev(np.concatenate([masks, np.zeros_like(masks[:1])]))
                rl = self.row_list()
                pad = np.full((32 * self.w_rows - rl.shape[0], rl.shape[1]), -1, np.int32)
                t["row_list"] = torch.from_numpy(np.concatenate([rl, pad])).to(device)
            self._on_device[key] = t
        return t

    def row_list(self) -> np.ndarray:
        """Each row's full columns (primary and secondary) as a compact
        list: int32 [R, K], ascending (so the primary columns come first),
        padded with -1 to K, the most columns of a row rounded up to an
        even number (the round kernel stages them as 16-bit pairs).  Made
        once per instance."""
        cached = getattr(self, "_row_list", None)
        if cached is not None:
            return cached
        inc = _unpack_bits(self.incidence, self.n_cols_full)
        per_row = inc.sum(1)
        k = max(2, -(-int(per_row.max()) // 2) * 2)
        out = np.full((self.n_rows, k), -1, dtype=np.int32)
        rows, cols = np.nonzero(inc)  # row-major: ascending columns per row
        start = np.concatenate([[0], np.cumsum(per_row)[:-1]])
        out[rows, np.arange(rows.size) - start[rows]] = cols
        out.setflags(write=False)
        object.__setattr__(self, "_row_list", out)
        return out

    # -- state packing -------------------------------------------------------
    def _split(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        flat = states[..., 0, :]
        return flat[..., : self.w_rows], flat[..., self.w_rows :]

    @staticmethod
    def _join(avail: torch.Tensor, covered: torch.Tensor) -> torch.Tensor:
        return torch.cat([avail, covered], dim=-1)[..., None, :]

    def initial_state(self) -> np.ndarray:
        """Root state: every row available, nothing covered: int32[1, D]."""
        avail = _pack_bits(np.ones((self.n_rows,), dtype=bool))
        covered = np.zeros((self.w_cols,), dtype=np.uint32)
        return np.concatenate([avail, covered])[None, :].view(np.int32)

    def state_with_rows_taken(self, rows) -> np.ndarray:
        """Root state after pre-selecting ``rows`` (host-side; e.g. clues)."""
        avail = _unpack_bits(self.initial_state()[0, : self.w_rows], self.n_rows)
        covered = np.zeros((self.n_primary,), dtype=bool)
        elim = _unpack_bits(self.elim, self.n_rows)
        cols = _unpack_bits(self.row_cols, self.n_primary)
        for r in rows:
            if not avail[r]:
                raise ValueError(f"row {r} conflicts with an earlier selection")
            if (covered & cols[r]).any():
                raise ValueError(f"row {r} re-covers an already-covered column")
            avail &= ~elim[r]
            covered |= cols[r]
        return np.concatenate([_pack_bits(avail), _pack_bits(covered)])[None, :].view(np.int32)

    def chosen_rows(self, solution_state) -> np.ndarray:
        """Solved state -> sorted row indices (the decode invariant above)."""
        avail = _unpack_bits(_as_u32(solution_state)[..., 0, : self.w_rows], self.n_rows)
        return np.nonzero(avail)[-1]

    # -- shared pieces -------------------------------------------------------
    def _counts(self, avail: torch.Tensor, covered: torch.Tensor):
        """cnt[L, C] available rows per primary column; unc[L, C] uncovered."""
        t = self._tensors(avail.device)
        cnt = popcount(avail[:, None, :] & t["col_rows"][None]).sum(-1, dtype=torch.int32)
        unc = ((covered[:, t["word"]] >> t["bit"]) & 1) == 0
        return cnt, unc

    @staticmethod
    def _lowest_row(rowmask: torch.Tensor) -> torch.Tensor:
        """[L, W_r] -> lowest set row index int32[L] (garbage -1 if empty)."""
        first_w = torch.argmax((rowmask != 0).to(torch.int32), dim=-1)
        word = rowmask.gather(-1, first_w[:, None])[:, 0]
        bitpos = 31 - clz(lowest_bit(word))  # -1 if word == 0
        return first_w.to(torch.int32) * 32 + bitpos

    def _take_row(self, avail, covered, row, active):
        """Select ``row`` where ``active``: cover its columns, drop conflicts."""
        t = self._tensors(avail.device)
        r = torch.clamp(row, 0, self.n_rows - 1).long()
        new_avail = avail & ~t["elim"][r]
        new_covered = covered | t["row_cols"][r]
        return (
            torch.where(active[:, None], new_avail, avail),
            torch.where(active[:, None], new_covered, covered),
        )

    def _row_bit(self, row: torch.Tensor) -> torch.Tensor:
        """int32[L] -> one-hot packed row mask int32[L, W_r]."""
        r = torch.clamp(row, 0, self.n_rows - 1).to(torch.int64)
        w_idx = torch.arange(self.w_rows, dtype=torch.int64, device=row.device)
        bit = _i32(torch.ones_like(r) << (r % 32))
        return torch.where(w_idx[None, :] == (r // 32)[:, None], bit[:, None],
                           torch.zeros((), dtype=torch.int32, device=row.device))

    def _forced_take(self, avail, covered):
        """One sweep: take the unique row of the lowest one-candidate column."""
        t = self._tensors(avail.device)
        cnt, unc = self._counts(avail, covered)
        forced = unc & (cnt == 1)
        has = forced.any(-1)
        col = torch.argmin(torch.where(forced, t["c_idx"][None], _BIG), dim=-1)
        row = self._lowest_row(t["col_rows"][col] & avail)
        avail, covered = self._take_row(avail, covered, row, has)
        return avail, covered, has

    def _fixpoint(self, states: torch.Tensor, max_sweeps: int):
        """Sweeps to the fixpoint: ``(states, batch sweeps, per-lane sweeps)``.

        The batch loop runs while any lane took a row (JAX's
        ``lax.while_loop``); a lane's own count stops at its first sweep
        that took nothing, inclusive, or at ``max_sweeps``."""
        avail, covered = self._split(states)
        lane_sweeps = torch.zeros(avail.shape[0], dtype=torch.int32, device=avail.device)
        active = torch.ones(avail.shape[0], dtype=torch.bool, device=avail.device)
        k = 0
        while k < max_sweeps:
            avail, covered, has = self._forced_take(avail, covered)
            lane_sweeps += active.to(torch.int32)
            active = active & has
            k += 1
            if not bool(has.any()):
                break
        sweeps = torch.tensor(k, dtype=torch.int32, device=avail.device)
        return self._join(avail, covered), sweeps, lane_sweeps

    # -- the three CSProblem functions ---------------------------------------
    def propagate(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Take the unique row of any 1-candidate column, to a fixpoint.

        One forced take per lane per sweep (lowest column first): two
        simultaneous takes could select conflicting rows.  The sweep count
        is batch-global, as in JAX (it is what ``run_frontier`` sums)."""
        out, sweeps, _ = self._fixpoint(states, self.max_sweeps)
        return out, sweeps

    def propagate_per_lane(self, states: torch.Tensor, max_sweeps: Optional[int] = None):
        """As :meth:`propagate`, with each lane's own sweep count int32[L]
        (the round kernel's per-lane definition)."""
        ms = self.max_sweeps if max_sweeps is None else max_sweeps
        out, _, lane_sweeps = self._fixpoint(states, ms)
        return out, lane_sweeps

    def status(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        avail, covered = self._split(states)
        cnt, unc = self._counts(avail, covered)
        contradiction = (unc & (cnt == 0)).any(-1)
        solved = ~unc.any(-1) & ~contradiction
        return solved, contradiction

    def branch(self, states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """MRV column; guess = take its lowest row, rest = exclude that row.

        Candidate columns include cnt == 1, so a lane whose forced chain
        ``max_sweeps`` cut short still has an active branch column."""
        t = self._tensors(states.device)
        avail, covered = self._split(states)
        cnt, unc = self._counts(avail, covered)
        branchable = unc & (cnt >= 1)
        key = torch.where(branchable, cnt * self.n_primary + t["c_idx"][None], _BIG)
        col = torch.argmin(key, dim=-1)
        row = self._lowest_row(t["col_rows"][col] & avail)
        active = branchable.any(-1)
        g_avail, g_covered = self._take_row(avail, covered, row, active)
        r_avail = torch.where(active[:, None], avail & ~self._row_bit(row), avail)
        return self._join(g_avail, g_covered), self._join(r_avail, covered)


_FIELDS = ("name", "n_rows", "n_primary", "col_rows", "row_cols", "elim", "max_sweeps",
           "incidence", "n_cols_full")


def cover_from_numpy(obj: Any) -> ExactCoverCSP:
    """The JAX package's ``ExactCoverCSP`` (or a mapping of its fields, as
    numpy) -> the port's instance, with the same content digest."""
    def get(k):
        return obj[k] if isinstance(obj, dict) else getattr(obj, k)

    fields = {}
    for k in _FIELDS:
        v = get(k)
        if k in ("col_rows", "row_cols", "elim", "incidence") and v is not None:
            v = _as_u32(v)
        elif k in ("n_rows", "n_primary", "max_sweeps", "n_cols_full"):
            v = int(v)
        fields[k] = v
    return ExactCoverCSP(**fields)


def build_cover(name: str, incidence, n_primary: int, max_sweeps: int = 64) -> ExactCoverCSP:
    """Build an instance from a bool incidence matrix [R, C_full].

    Columns ``[0, n_primary)`` are primary (covered exactly once); the rest
    are secondary (at most once, enforced through row conflicts).  Every
    row must cover at least one primary column (the decode invariant)."""
    a = np.asarray(incidence, dtype=bool)
    if a.ndim != 2:
        raise ValueError(f"incidence must be 2-D, got {a.shape}")
    n_rows = a.shape[0]
    if not (0 < n_primary <= a.shape[1]):
        raise ValueError(f"n_primary={n_primary} out of range for {a.shape}")
    if not a[:, :n_primary].any(axis=1).all():
        raise ValueError("every row must cover at least one primary column")
    # int32 accumulation: a uint8 product wraps at 256 shared columns.
    conflict = (a.astype(np.int32) @ a.astype(np.int32).T) > 0
    np.fill_diagonal(conflict, False)
    return ExactCoverCSP(
        name=name,
        n_rows=n_rows,
        n_primary=n_primary,
        col_rows=_pack_bits(a[:, :n_primary].T),
        row_cols=_pack_bits(a[:, :n_primary]),
        elim=_pack_bits(conflict),
        max_sweeps=max_sweeps,
        incidence=_pack_bits(a),
        n_cols_full=a.shape[1],
    )


def sudoku_cover(geom, max_sweeps: int = 64) -> ExactCoverCSP:
    """Sudoku as exact cover: row r*n*n + c*n + (d-1) = "digit d in cell
    (r, c)"; primary columns are the 4n^2 constraints (cell filled,
    digit-in-row, digit-in-column, digit-in-box).  Clue grids become root
    states through :meth:`ExactCoverCSP.state_with_rows_taken` with
    :func:`sudoku_clue_rows`."""
    n = geom.n
    a = np.zeros((n * n * n, 4 * n * n), dtype=bool)
    for r in range(n):
        for c in range(n):
            b = (r // geom.box_h) * geom.n_hboxes + (c // geom.box_w)
            for d in range(n):
                row = r * n * n + c * n + d
                a[row, r * n + c] = True
                a[row, n * n + r * n + d] = True
                a[row, 2 * n * n + c * n + d] = True
                a[row, 3 * n * n + b * n + d] = True
    return build_cover(f"sudoku-cover{geom.box_h}x{geom.box_w}", a, 4 * n * n,
                       max_sweeps=max_sweeps)


def sudoku_clue_rows(grid) -> list[int]:
    """Int clue grid [n, n] (0 = empty) -> cover row indices of the clues."""
    grid = np.asarray(grid)
    n = grid.shape[0]
    return [r * n * n + c * n + (int(grid[r, c]) - 1)
            for r in range(n) for c in range(n) if grid[r, c] > 0]


def decode_sudoku_cover(problem: ExactCoverCSP, solution_state, n: int) -> np.ndarray:
    """Solved sudoku-cover state -> int grid [n, n]."""
    grid = np.zeros((n, n), dtype=np.int32)
    for row in problem.chosen_rows(solution_state):
        row = int(row)
        grid[row // (n * n), (row // n) % n] = row % n + 1
    return grid
