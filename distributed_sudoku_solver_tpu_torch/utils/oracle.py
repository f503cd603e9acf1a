"""Clean-room CPU oracle: deterministic DFS backtracker + solution validator.

A pure-Python copy of the JAX package's ``utils/oracle.py``, kept so the
port imports nothing of that package.  It is a test authority: an
independent, geometry-generic solver whose search order is fixed —

* branch on the **first empty cell in row-major order**, and
* try digits in **ascending order**,

so the first solution it returns is the lexicographically-least completion,
the one the solver's ``branch='first'`` rule finds.  Not written for speed —
written to be obviously correct.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry, geometry_for_size


def _box_index(geom: Geometry, r: int, c: int) -> int:
    return (r // geom.box_h) * geom.n_hboxes + (c // geom.box_w)


def is_valid_solution(grid, geom: Optional[Geometry] = None) -> bool:
    """True iff ``grid`` is a complete, consistent board (every unit = 1..n)."""
    g = np.asarray(grid, dtype=np.int64)
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    if g.shape != (n, n) or g.min() < 1 or g.max() > n:
        return False
    want = frozenset(range(1, n + 1))
    for i in range(n):
        if frozenset(g[i, :]) != want or frozenset(g[:, i]) != want:
            return False
    for br in range(geom.n_vboxes):
        for bc in range(geom.n_hboxes):
            box = g[
                br * geom.box_h : (br + 1) * geom.box_h,
                bc * geom.box_w : (bc + 1) * geom.box_w,
            ]
            if frozenset(box.ravel()) != want:
                return False
    return True


def is_consistent_partial(grid, geom: Optional[Geometry] = None) -> bool:
    """True iff no unit of ``grid`` repeats a nonzero digit (0 = empty ok)."""
    g = np.asarray(grid, dtype=np.int64)
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    rows = [0] * n
    cols = [0] * n
    boxes = [0] * n
    for r in range(n):
        for c in range(n):
            v = int(g[r, c])
            if v == 0:
                continue
            bit = 1 << (v - 1)
            b = _box_index(geom, r, c)
            if (rows[r] | cols[c] | boxes[b]) & bit:
                return False
            rows[r] |= bit
            cols[c] |= bit
            boxes[b] |= bit
    return True


def solve_oracle(
    grid,
    geom: Optional[Geometry] = None,
    count_nodes: bool = False,
):
    """Solve by deterministic DFS; returns np.int64[n, n] or None if unsat.

    With ``count_nodes=True`` returns ``(solution_or_None, nodes_expanded)``
    where a "node" is one cell-assignment attempt.
    """
    g = np.asarray(grid, dtype=np.int64).copy()
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    full = geom.full_mask

    rows = [0] * n
    cols = [0] * n
    boxes = [0] * n
    empties = []
    for r in range(n):
        for c in range(n):
            v = int(g[r, c])
            if v == 0:
                empties.append((r, c))
                continue
            bit = 1 << (v - 1)
            b = _box_index(geom, r, c)
            if (rows[r] | cols[c] | boxes[b]) & bit:
                return (None, 0) if count_nodes else None
            rows[r] |= bit
            cols[c] |= bit
            boxes[b] |= bit

    nodes = 0

    def dfs(i: int) -> bool:
        nonlocal nodes
        if i == len(empties):
            return True
        r, c = empties[i]  # first-empty, row-major: empties was built row-major
        b = _box_index(geom, r, c)
        avail = full & ~(rows[r] | cols[c] | boxes[b])
        while avail:
            bit = avail & -avail  # ascending digit order
            avail &= avail - 1
            nodes += 1
            rows[r] |= bit
            cols[c] |= bit
            boxes[b] |= bit
            g[r, c] = bit.bit_length()
            if dfs(i + 1):
                return True
            rows[r] &= ~bit
            cols[c] &= ~bit
            boxes[b] &= ~bit
            g[r, c] = 0
        return False

    ok = dfs(0)
    sol = g if ok else None
    return (sol, nodes) if count_nodes else sol


def count_solutions(grid, geom: Optional[Geometry] = None, limit: int = 2) -> int:
    """Count solutions up to ``limit`` (uniqueness checks for test fixtures)."""
    g = np.asarray(grid, dtype=np.int64).copy()
    n = g.shape[0]
    geom = geom or geometry_for_size(n)
    full = geom.full_mask

    rows = [0] * n
    cols = [0] * n
    boxes = [0] * n
    empties = []
    for r in range(n):
        for c in range(n):
            v = int(g[r, c])
            if v == 0:
                empties.append((r, c))
                continue
            bit = 1 << (v - 1)
            b = _box_index(geom, r, c)
            if (rows[r] | cols[c] | boxes[b]) & bit:
                return 0
            rows[r] |= bit
            cols[c] |= bit
            boxes[b] |= bit

    found = 0

    def dfs(i: int) -> bool:
        nonlocal found
        if i == len(empties):
            found += 1
            return found >= limit
        r, c = empties[i]
        b = _box_index(geom, r, c)
        avail = full & ~(rows[r] | cols[c] | boxes[b])
        while avail:
            bit = avail & -avail
            avail &= avail - 1
            rows[r] |= bit
            cols[c] |= bit
            boxes[b] |= bit
            stop = dfs(i + 1)
            rows[r] &= ~bit
            cols[c] &= ~bit
            boxes[b] &= ~bit
            if stop:
                return True
        return False

    dfs(0)
    return found
