"""Puzzle corpus + deterministic generator (copy of the JAX package's).

A small embedded corpus of public benchmark boards and a seeded generator
for any geometry.  For a given seed the boards equal the JAX package's.
``make_puzzle(unique=True)`` checks uniqueness with the native C++ oracle
(:mod:`..native`) where it builds, else with the pure-Python one
(:mod:`.oracle`); both count solutions exactly, so the boards are the same.
:func:`puzzle_batch` stacks generated boards, memoised on disk under
``cache_dir`` (or ``DSST_PUZZLE_CACHE``) in the JAX package's file format.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.utils.oracle import count_solutions as _py_count

# Bump when random_solution/make_puzzle output could change for a given seed:
# it keys the on-disk batch cache, so stale boards are never served.
_GENERATOR_VERSION = 1


def _count_solutions_fast(grid, geom: Optional[Geometry] = None, limit: int = 2) -> int:
    """Uniqueness probe: the native oracle where it builds (carving a puzzle
    runs dozens of these), else the pure-Python one, which stays the
    independent authority the native library is tested against."""
    from distributed_sudoku_solver_tpu_torch import native

    if native.available():
        return native.count_solutions(grid, geom, limit=limit)
    return _py_count(grid, geom, limit=limit)


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
            if _count_solutions_fast(puzzle, geom, limit=2) != 1:
                puzzle[r, c] = saved
                continue
        remaining -= 1
    return puzzle


def batch_cache_path(
    geom: Geometry,
    count: int,
    seed: int = 0,
    n_clues: Optional[int] = None,
    unique: bool = True,
    cache_dir: Optional[str] = None,
) -> Optional[str]:
    """On-disk cache path :func:`puzzle_batch` uses for these parameters
    (None when no cache dir is configured): the JAX package's key format,
    so either package reads the other's corpus."""
    cache_dir = cache_dir or os.environ.get("DSST_PUZZLE_CACHE")
    if not cache_dir:
        return None
    key = (
        f"v{_GENERATOR_VERSION}_{geom.box_h}x{geom.box_w}"
        f"_{count}_{seed}_{n_clues}_{int(unique)}"
    )
    return os.path.join(cache_dir, f"puzzles_{key}.npy")


def puzzle_batch(
    geom: Geometry,
    count: int,
    seed: int = 0,
    n_clues: Optional[int] = None,
    unique: bool = True,
    cache_dir: Optional[str] = None,
) -> np.ndarray:
    """Stack ``count`` generated puzzles (seeds ``seed..seed+count-1``) into
    int64[count, n, n], memoised on disk when a cache dir is configured.
    Generation is deterministic, so the cache changes latency only."""
    path = batch_cache_path(geom, count, seed, n_clues, unique, cache_dir)
    if path and os.path.exists(path):
        return np.load(path)
    batch = np.stack(
        [make_puzzle(geom, seed + i, n_clues=n_clues, unique=unique) for i in range(count)]
    )
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # np.save appends '.npy' unless the name already ends with it.
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, batch)
        os.replace(tmp, path)
    return batch


@functools.lru_cache(maxsize=None)
def solved_board(geom: Geometry) -> np.ndarray:
    """A complete valid board for ``geom`` (cached; read-only): the
    zero-work padding job of the batch paths."""
    board = random_solution(geom, seed=0).astype(np.int32)
    board.setflags(write=False)
    return board
