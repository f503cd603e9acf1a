"""Quantiles of the engine's log2 latency histograms, frozen.

Copied from ``distributed_sudoku_solver_tpu_torch/obs/hist.py``
(``hist_quantile``).  ``/metrics`` serves each histogram as
``{"type": "log2_hist", "edge0_ms": ..., "counts": [...]}``; bucket ``i``
holds samples up to ``edge0_ms * 2**i``, the last one everything above.
"""

from __future__ import annotations

from typing import Optional


def delta(before: Optional[dict], after: Optional[dict]) -> Optional[dict]:
    """The samples recorded between two readings of one histogram."""
    if after is None:
        return None
    counts = [int(c) for c in after["counts"]]
    if before is not None:
        if len(before["counts"]) != len(counts) or before.get("edge0_ms") != after.get("edge0_ms"):
            raise ValueError("the two readings of a histogram have different buckets")
        counts = [a - int(b) for a, b in zip(counts, before["counts"])]
    return {"edge0_ms": float(after["edge0_ms"]), "counts": counts}


def quantile(d: Optional[dict], q: float) -> Optional[float]:
    """The ``q``-quantile in ms: log-linear inside the bucket that crosses
    the rank; the overflow bucket reads its lower edge.  None when empty."""
    if d is None:
        return None
    counts = d["counts"]
    total = sum(counts)
    if total <= 0:
        return None
    edge0 = d["edge0_ms"]
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            if i >= len(counts) - 1:
                return edge0 * (2.0 ** (i - 1))
            upper = edge0 * (2.0 ** i)
            lower = 0.0 if i == 0 else edge0 * (2.0 ** (i - 1))
            return lower + (upper - lower) * (target - cum) / c
        cum += c
    return edge0 * (2.0 ** (len(counts) - 2))
