"""Operation counts of the frontier round: one model for the bounds and the gauge.

``chip_smoke.py`` bounds K1's and K2's times by the integer operations the
data needs (sweeps times :func:`sweep_ops`, live lane-rounds times
:func:`round_ops`), and the compile watch's cost plane
(``obs/compilewatch.py``) prices one serving round with
:func:`advance_round_cost`.  Both read the counts here, so the bound and
the gauge cannot drift apart.

The counts are of the plain algorithm (``ops/propagate.py``,
``ops/frontier.py``), in int32 operations: the kernels are integer bit
algebra.  Plain arithmetic on a geometry's sizes; no torch.
"""

from __future__ import annotations


def sweep_ops(geom, rules: str) -> int:
    """Integer operations of one sweep of one board, counted on the plain
    algorithm: unit reductions at 1 op (OR) or 3 ops (once/twice) per cell
    per unit type, plus the per-cell combines of each stage."""
    n2 = geom.n * geom.n
    ops = (1 + 3 + 5) * n2 + (9 + 4) * n2  # elimination, hidden singles
    if rules in ("extended", "subsets"):
        ops += 2 * n2 * (3 + 2 * (geom.n_hboxes + geom.box_h)) + 2 * n2
    if rules == "subsets":
        ops += 21 * geom.n ** 3
    return ops


def round_ops(geom) -> int:
    """Integer operations of one round outside the fixpoint: status
    (3 unit types, 4 ops per cell each, + 2 per cell), branch key and
    argmin (3 per cell), row copy for the push or pop (1 per cell)."""
    return (12 + 2 + 3 + 1) * geom.n * geom.n


def advance_round_cost(geom, lanes: int, rules: str) -> dict:
    """The cost model of one frontier round of ``lanes`` lanes with one
    fixpoint sweep, from the shape alone (the unit JAX's
    ``cost_analysis()`` gives for a chunked advance, which prices a
    ``while`` body once).  ``flops`` is int32 operations (the field keeps
    the JAX name); ``bytes_accessed`` is each lane's working board read
    and written once and one stack row pushed or popped, at 4 bytes a
    cell."""
    n2 = geom.n * geom.n
    return {
        "flops": float(lanes * (sweep_ops(geom, rules) + round_ops(geom))),
        "bytes_accessed": float(lanes * 3 * n2 * 4),
    }
