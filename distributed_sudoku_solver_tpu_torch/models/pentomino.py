"""Pentomino tilings as exact cover (port of the JAX package's ``models/pentomino.py``).

Tile an h x w rectangle (h*w == 60) with the 12 distinct pentominoes, each
used exactly once.  Row = one placement (piece, orientation, offset);
columns = 12 piece ids + h*w board cells, all primary — the classic DLX
benchmark instance, solved by the same engine as Sudoku.
"""

from __future__ import annotations

import functools

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.cover import ExactCoverCSP, build_cover

# The 12 pentominoes (Conway naming), as (row, col) cell sets.
PENTOMINOES: dict[str, tuple[tuple[int, int], ...]] = {
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

PIECE_NAMES = tuple(PENTOMINOES)


def _normalize(cells: frozenset[tuple[int, int]]) -> tuple[tuple[int, int], ...]:
    r0 = min(r for r, _ in cells)
    c0 = min(c for _, c in cells)
    return tuple(sorted((r - r0, c - c0) for r, c in cells))


def orientations(cells) -> list[tuple[tuple[int, int], ...]]:
    """All distinct rotations/reflections of a cell set (1, 2, 4 or 8)."""
    seen = set()
    cur = frozenset(cells)
    for _ in range(2):
        for _ in range(4):
            seen.add(_normalize(cur))
            cur = frozenset((c, -r) for r, c in cur)  # rotate 90 degrees
        cur = frozenset((r, -c) for r, c in cur)  # reflect
    return sorted(seen)


@functools.lru_cache(maxsize=None)
def placements(
    height: int, width: int
) -> tuple[tuple[int, tuple[int, int], tuple[tuple[int, int], ...]], ...]:
    """All (piece, offset, oriented-shape) placements, in cover-row order.

    This enumeration order *defines* the row indices of
    :func:`pentomino_cover`; decoding looks placements up by that index.
    """
    out = []
    for p, name in enumerate(PIECE_NAMES):
        for shape in orientations(PENTOMINOES[name]):
            sh = max(r for r, _ in shape) + 1
            sw = max(c for _, c in shape) + 1
            for r0 in range(height - sh + 1):
                for c0 in range(width - sw + 1):
                    out.append((p, (r0, c0), shape))
    return tuple(out)


def pentomino_cover(
    height: int = 6, width: int = 10, max_sweeps: int = 64
) -> ExactCoverCSP:
    if height * width != 60:
        raise ValueError(f"board must have 60 cells, got {height}x{width}")
    n_primary = len(PIECE_NAMES) + height * width
    rows: list[np.ndarray] = []
    for p, (r0, c0), shape in placements(height, width):
        row = np.zeros(n_primary, dtype=bool)
        row[p] = True
        for r, c in shape:
            row[len(PIECE_NAMES) + (r0 + r) * width + (c0 + c)] = True
        rows.append(row)
    return build_cover(
        f"pentomino{height}x{width}",
        np.stack(rows),
        n_primary,
        max_sweeps=max_sweeps,
    )


def decode_tiling(problem: ExactCoverCSP, solution_state, height: int, width: int):
    """Solved state -> int grid [h, w] of piece ids (0..11)."""
    placed = placements(height, width)
    grid = np.full((height, width), -1, dtype=np.int32)
    for r in problem.chosen_rows(solution_state):
        piece, (r0, c0), shape = placed[int(r)]
        for dr, dc in shape:
            grid[r0 + dr, c0 + dc] = piece
    return grid


def is_valid_tiling(grid) -> bool:
    """Every cell covered; every piece used exactly once (5 cells each)."""
    grid = np.asarray(grid)
    if (grid < 0).any():
        return False
    counts = np.bincount(grid.ravel(), minlength=len(PIECE_NAMES))
    return grid.size == 60 and (counts == 5).all() and len(counts) == len(PIECE_NAMES)
