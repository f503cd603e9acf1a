"""N-queens as generalized exact cover (port of the JAX package's ``models/nqueens.py``).

Row r*n+c = "a queen on square (r, c)".  Primary columns: the n ranks and
n files (each must hold exactly one queen).  Secondary columns: the 2n-1
diagonals and 2n-1 anti-diagonals (at most one queen) — the textbook
primary/secondary DLX encoding, solved here by the same lane-stack
engine as Sudoku.
"""

from __future__ import annotations

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.cover import ExactCoverCSP, build_cover


def nqueens_cover(n: int, max_sweeps: int = 64) -> ExactCoverCSP:
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    n_primary = 2 * n
    n_cols = n_primary + 2 * (2 * n - 1)
    a = np.zeros((n * n, n_cols), dtype=bool)
    for r in range(n):
        for c in range(n):
            row = r * n + c
            a[row, r] = True  # rank
            a[row, n + c] = True  # file
            a[row, n_primary + r + c] = True  # diagonal
            a[row, n_primary + (2 * n - 1) + (r - c + n - 1)] = True  # anti-diag
    return build_cover(f"nqueens{n}", a, n_primary, max_sweeps=max_sweeps)


def decode_queens(problem: ExactCoverCSP, solution_state, n: int) -> list[tuple[int, int]]:
    """Solved state -> [(rank, file), ...] queen placements."""
    return [(int(r) // n, int(r) % n) for r in problem.chosen_rows(solution_state)]


def is_valid_queens(placements, n: int) -> bool:
    """n queens, no two sharing a rank, file, diagonal or anti-diagonal."""
    if len(placements) != n:
        return False
    rs = {r for r, _ in placements}
    cs = {c for _, c in placements}
    ds = {r + c for r, c in placements}
    ads = {r - c for r, c in placements}
    return len(rs) == len(cs) == len(ds) == len(ads) == n
