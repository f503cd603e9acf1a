"""Puzzle corpus + deterministic generator (copy of the JAX package's).

A small embedded corpus of public benchmark boards and a seeded generator
for any geometry.  For a given seed the boards equal the JAX package's.
``make_puzzle(unique=True)`` checks uniqueness with the pure-Python oracle
(:mod:`.oracle`); the native C++ oracle is not part of this package.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.utils.oracle import count_solutions


def parse_line(line: str, n: int = 9) -> np.ndarray:
    """Parse an n*n-char puzzle string ('0' or '.' = empty) to int64[n, n]."""
    line = line.strip().replace(".", "0")
    if len(line) != n * n:
        raise ValueError(f"expected {n * n} chars, got {len(line)}")
    vals = [int(ch, 36) for ch in line]  # base36 so 16x16 strings fit one char
    if any(v > n for v in vals):
        raise ValueError(f"digit out of range for a {n}x{n} board")
    return np.asarray(vals, dtype=np.int64).reshape(n, n)


def to_line(grid) -> str:
    g = np.asarray(grid).ravel()
    return "".join(np.base_repr(int(v), 36).lower() for v in g)


# Classic public example board (easy; solvable by propagation alone).
EASY_9 = parse_line(
    "530070000600195000098000060800060003"
    "400803001700020006060000280000419005000080079"
)

# Widely published hard benchmark boards.
HARD_9_LINES = [
    # "AI Escargot" (Inkala)
    "100007090030020008009600500005300900010080002600004000300000010040000007007000300",
    # Inkala 2010
    "800000000003600000070090200050007000000045700000100030001000068008500010090000400",
    # 17-clue board popularized by Norvig's solver essay
    "000000010400000000020000000000050407008000300001090000300400200050100000000806000",
]
HARD_9 = [parse_line(s) for s in HARD_9_LINES]


def random_solution(geom: Geometry, seed: int) -> np.ndarray:
    """A shuffled valid complete board (deterministic in ``seed``): the
    shifted-pattern Latin construction under digit relabel, row/col
    permutations within bands/stacks, band/stack permutations and an
    optional transpose."""
    rng = np.random.default_rng(seed)
    n, bh, bw = geom.n, geom.box_h, geom.box_w
    base = np.empty((n, n), dtype=np.int64)
    for r in range(n):
        shift = (r % bh) * bw + (r // bh)
        for c in range(n):
            base[r, c] = (c + shift) % n + 1

    relabel = np.concatenate([[0], rng.permutation(n) + 1])
    base = relabel[base]

    row_order = np.concatenate(
        [band * bh + rng.permutation(bh) for band in rng.permutation(geom.n_vboxes)]
    )
    col_order = np.concatenate(
        [stack * bw + rng.permutation(bw) for stack in rng.permutation(geom.n_hboxes)]
    )
    base = base[row_order][:, col_order]
    if bh == bw and rng.integers(2):
        base = base.T.copy()
    return base


def make_puzzle(
    geom: Geometry,
    seed: int,
    n_clues: Optional[int] = None,
    unique: bool = True,
    max_probe: Optional[int] = None,
) -> np.ndarray:
    """Carve a puzzle out of a random solution (deterministic in ``seed``).

    Removes cells in a random order down toward ``n_clues`` givens; with
    ``unique=True`` every removal is checked to keep the solution unique.
    With ``unique=False`` the board keeps its parent solution, so it is
    always satisfiable."""
    sol = random_solution(geom, seed)
    rng = np.random.default_rng(seed + 0x9E3779B9)
    n = geom.n
    if n_clues is None:
        n_clues = int(n * n * 0.35)
    puzzle = sol.copy()
    order = rng.permutation(n * n)
    remaining = n * n
    probes = 0
    for idx in order:
        if remaining <= n_clues:
            break
        if max_probe is not None and probes >= max_probe:
            break
        r, c = divmod(int(idx), n)
        saved = puzzle[r, c]
        puzzle[r, c] = 0
        if unique:
            probes += 1
            if count_solutions(puzzle, geom, limit=2) != 1:
                puzzle[r, c] = saved
                continue
        remaining -= 1
    return puzzle


@functools.lru_cache(maxsize=None)
def solved_board(geom: Geometry) -> np.ndarray:
    """A complete valid board for ``geom`` (cached; read-only): the
    zero-work padding job of the batch paths."""
    board = random_solution(geom, seed=0).astype(np.int32)
    board.setflags(write=False)
    return board
