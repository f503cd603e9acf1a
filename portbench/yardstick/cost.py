"""Integer operations of the frontier round, frozen.

Copied from ``distributed_sudoku_solver_tpu_torch/ops/cost.py``
(``sweep_ops``, ``round_ops``), which ``chip_smoke.py`` uses to bound K1's and
K2's device times.  The counts are of the plain algorithm, in int32
operations; ``n``, ``box_h`` and ``n_hboxes`` are the geometry's.
"""

from __future__ import annotations


def sweep_ops(n: int, box_h: int, n_hboxes: int, rules: str) -> int:
    """Integer operations of one sweep of one board: unit reductions at 1 op
    (OR) or 3 ops (once/twice) per cell per unit type, plus the per-cell
    combines of each stage."""
    n2 = n * n
    ops = (1 + 3 + 5) * n2 + (9 + 4) * n2  # elimination, hidden singles
    if rules in ("extended", "subsets"):
        ops += 2 * n2 * (3 + 2 * (n_hboxes + box_h)) + 2 * n2
    if rules == "subsets":
        ops += 21 * n ** 3
    return ops


def round_ops(n: int) -> int:
    """Integer operations of one round outside the fixpoint: status (3 unit
    types, 4 ops per cell each, + 2 per cell), branch key and argmin (3 per
    cell), row copy for the push or pop (1 per cell)."""
    return (12 + 2 + 3 + 1) * n * n
