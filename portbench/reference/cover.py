"""Plain numpy reference of exact cover: the instances, a counter of their
exact covers and a judge of one cover.

An exact cover of a 0/1 incidence matrix (rows x columns, the first
``n_primary`` columns primary, the rest secondary) is a set of rows that
covers every primary column exactly once and every secondary column at
most once.  The instances are built here from their definitions, not from
the program: a pentomino rectangle's rows are the placements of the 12
pieces in every rotation and reflection and at every offset (columns: 12
pieces, then the cells row by row); an n-queens board's rows are its
squares (primary: ranks and files; secondary: both diagonals).

:func:`count_exact_covers` counts by a frontier of ``(available rows,
covered columns)`` states.  A state is expanded on the column with the
fewest available rows (the lowest such column): one child a row that
covers it, each child dropping every row that shares a column with the
row taken.  A state with every primary column covered is a cover; one
with an uncovered primary column and no row for it is dead.  States are
expanded a block at a time, the newest block first, so the frontier holds
at most a block's children a level; the available rows are kept packed,
eight to a byte.  Column counts are float32 products of 0/1 matrices,
exact below 2**24 rows.  It runs on the host and imports nothing of the
program, and nothing of JAX.
"""

from __future__ import annotations

import numpy as np

# The 12 pentominoes as (row, column) cells, Conway's names.
PENTOMINOES = {
    "F": ((0, 1), (0, 2), (1, 0), (1, 1), (2, 1)),
    "I": ((0, 0), (1, 0), (2, 0), (3, 0), (4, 0)),
    "L": ((0, 0), (1, 0), (2, 0), (3, 0), (3, 1)),
    "N": ((0, 1), (1, 1), (2, 0), (2, 1), (3, 0)),
    "P": ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0)),
    "T": ((0, 0), (0, 1), (0, 2), (1, 1), (2, 1)),
    "U": ((0, 0), (0, 2), (1, 0), (1, 1), (1, 2)),
    "V": ((0, 0), (1, 0), (2, 0), (2, 1), (2, 2)),
    "W": ((0, 0), (1, 0), (1, 1), (2, 1), (2, 2)),
    "X": ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1)),
    "Y": ((0, 1), (1, 0), (1, 1), (2, 1), (3, 1)),
    "Z": ((0, 0), (0, 1), (1, 1), (2, 1), (2, 2)),
}
BLOCK = 1 << 12


def shapes(cells) -> set:
    """Every rotation and reflection of a cell set, each shifted to touch
    both axes, as a sorted tuple of cells."""
    out = set()
    for flip in (False, True):
        cur = [(r, -c) if flip else (r, c) for r, c in cells]
        for _ in range(4):
            cur = [(c, -r) for r, c in cur]
            r0, c0 = min(r for r, _ in cur), min(c for _, c in cur)
            out.add(tuple(sorted((r - r0, c - c0) for r, c in cur)))
    return out


def pentomino_incidence(height: int, width: int) -> tuple[np.ndarray, int]:
    """bool[R, 12 + height * width] and its number of primary columns (all
    of them): one row a placement of one piece."""
    rows = []
    for p, cells in enumerate(PENTOMINOES.values()):
        for shape in sorted(shapes(cells)):
            sh = 1 + max(r for r, _ in shape)
            sw = 1 + max(c for _, c in shape)
            for r0 in range(height - sh + 1):
                for c0 in range(width - sw + 1):
                    row = np.zeros(12 + height * width, dtype=bool)
                    row[p] = True
                    for r, c in shape:
                        row[12 + (r0 + r) * width + c0 + c] = True
                    rows.append(row)
    return np.stack(rows), 12 + height * width


def nqueens_incidence(n: int) -> tuple[np.ndarray, int]:
    """bool[n * n, 6n - 2] and its 2n primary columns: a row a square, its
    rank and file primary, its two diagonals secondary."""
    a = np.zeros((n * n, 6 * n - 2), dtype=bool)
    for r in range(n):
        for c in range(n):
            for col in (r, n + c, 2 * n + r + c, 4 * n - 1 + r - c + n - 1):
                a[r * n + c, col] = True
    return a, 2 * n


def same_rows(a, b) -> bool:
    """Two incidence matrices hold the same rows, each once, in any order."""
    a, b = np.asarray(a, dtype=bool), np.asarray(b, dtype=bool)
    if a.shape != b.shape:
        return False
    ua, ub = (np.unique(x, axis=0) for x in (a, b))
    return len(ua) == len(a) and np.array_equal(ua, ub)


def count_exact_covers(incidence, n_primary: int, block: int = BLOCK) -> int:
    """The number of exact covers of ``incidence`` (bool[R, C]), by the
    frontier of the module docstring."""
    inc = np.asarray(incidence, dtype=bool)
    n_rows, n_cols = inc.shape
    f = inc.astype(np.float32)
    # Rows that share a column (a row shares with itself), packed like a state's rows.
    keep = ~np.packbits((f @ f.T) > 0, axis=1)
    primary = f[:, :n_primary]
    # Each column's rows, padded with row n_rows, which is never available.
    per_col = inc.sum(0)
    by_col = np.full((n_cols, max(int(per_col.max()), 1)), n_rows)
    for c in range(n_cols):
        by_col[c, : per_col[c]] = np.flatnonzero(inc[:, c])
    found = 0
    pending = [(np.packbits(np.ones((1, n_rows), dtype=bool), axis=1),
                np.zeros((1, n_cols), dtype=bool))]
    while pending:
        packed, covered = pending.pop()
        if len(packed) > block:
            pending.append((packed[block:], covered[block:]))
            packed, covered = packed[:block], covered[:block]
        avail = np.unpackbits(packed, axis=1, count=n_rows + 1).view(bool)
        counts = avail[:, :n_rows].astype(np.float32) @ primary
        open_ = ~covered[:, :n_primary]
        done = ~open_.any(1)
        found += int(done.sum())
        live = ~done & ~(open_ & (counts == 0)).any(1)
        if not live.any():
            continue
        packed, covered, avail = packed[live], covered[live], avail[live]
        col = np.where(open_[live], counts[live], n_rows + 1).argmin(1)
        cand = by_col[col, : per_col[col].max()]
        state, k = np.nonzero(np.take_along_axis(avail, cand, 1))
        row = cand[state, k]
        pending.append((packed[state] & keep[row], covered[state] | inc[row]))
    return found


def bits(words, k: int) -> np.ndarray:
    """bool[..., k]: bit b of word w is entry 32 w + b, of int32 words
    (uint32 patterns) ``words[..., W]``."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    out = (w[..., :, None] >> np.arange(32)) & 1
    return out.reshape(*out.shape[:-2], -1)[..., :k].astype(bool)


def chosen_rows(state, n_rows: int) -> list:
    """The rows a cover state has taken: its first ``ceil(n_rows / 32)``
    words are the available rows, and at a cover those are the rows taken
    (every other row shares a covered primary column with one of them)."""
    flat = np.asarray(state).reshape(-1)
    return np.flatnonzero(bits(flat[: -(-n_rows // 32)], n_rows)).tolist()


def is_exact_cover(incidence, n_primary: int, chosen) -> bool:
    """``chosen`` (row indices) are distinct rows of ``incidence`` that
    cover every primary column once and every secondary column at most
    once."""
    inc = np.asarray(incidence, dtype=bool)
    rows = np.asarray(list(chosen), dtype=np.int64)
    if len(set(rows.tolist())) != len(rows) or ((rows < 0) | (rows >= len(inc))).any():
        return False
    hits = inc[rows].sum(0, dtype=np.int64)
    return bool((hits[:n_primary] == 1).all()) and bool((hits[n_primary:] <= 1).all())
