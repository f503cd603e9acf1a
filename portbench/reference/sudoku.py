"""Plain numpy judge of Sudoku answers.

An answer to a board is right when it is a complete grid in which every row,
column and box holds each digit ``1..n`` once, and every given of the board
stands in it unchanged.  Every board of this benchmark has exactly one
solution, so an "unsatisfiable" verdict on one is wrong, and "unknown" is an
answer missing, not a wrong one.
"""

from __future__ import annotations

import numpy as np


def valid_grids(grids: np.ndarray, box_h: int, box_w: int) -> np.ndarray:
    """bool[b]: each grid of int[b, n, n] is a complete valid solution.

    Every cell holds a digit ``1..n``, and in every row, column and box the
    digits' one-hot masks ``1 << (d - 1)`` sum to ``2**n - 1``.  A sum of
    ``n`` powers of two has as many set bits as terms only when no two are
    equal (equal terms carry), so the sum is ``2**n - 1`` exactly when the
    unit holds each digit once."""
    g = np.asarray(grids)
    b, n, _ = g.shape
    if n != box_h * box_w:
        raise ValueError(f"grids of side {n} for boxes {box_h}x{box_w}")
    in_range = ((g >= 1) & (g <= n)).all(axis=(1, 2))
    onehot = np.zeros(n + 1, dtype=np.uint32)
    onehot[1:] = np.left_shift(np.uint32(1), np.arange(n, dtype=np.uint32))
    bits = onehot[np.clip(g, 0, n)]
    full = np.uint32((1 << n) - 1)
    rows = (bits.sum(2, dtype=np.uint32) == full).all(1)
    cols = (bits.sum(1, dtype=np.uint32) == full).all(1)
    boxes = bits.reshape(b, n // box_h, box_h, n // box_w, box_w).sum(4, dtype=np.uint32).sum(2)
    return in_range & rows & cols & (boxes == full).all(axis=(1, 2))


def keeps_givens(boards: np.ndarray, grids: np.ndarray) -> np.ndarray:
    """bool[b]: every nonzero cell of ``boards[i]`` equals ``grids[i]``."""
    boards = np.asarray(boards)
    grids = np.asarray(grids)
    return ((boards == 0) | (boards == grids)).all(axis=(1, 2))


def right_answers(boards: np.ndarray, grids: np.ndarray, box_h: int, box_w: int) -> np.ndarray:
    """bool[b]: ``grids[i]`` is a valid solution of ``boards[i]``."""
    if np.shape(boards) != np.shape(grids):
        raise ValueError(f"boards {np.shape(boards)} and answers {np.shape(grids)} differ")
    return valid_grids(grids, box_h, box_w) & keeps_givens(boards, grids)
