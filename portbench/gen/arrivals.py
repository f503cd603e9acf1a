"""Open-loop arrival schedules.

A Poisson process at ``rate`` per second, stratified: the gaps are the
exponential distribution's quantiles at ``(i + 0.5) / count``, put in a
seeded order.  Every seed then sends the same number of requests with the
same set of gaps, so the seed changes the order of the load and not its
amount; within a run the arrivals still bunch and thin as Poisson arrivals
do.
"""

from __future__ import annotations

import numpy as np


def poisson_due(g: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start, float64[count], with
    ``count = round(rate * seconds)``; the last is due before ``seconds``."""
    count = max(1, int(round(rate * seconds)))
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / rate
    gaps = g.permutation(gaps)
    due = np.cumsum(gaps)
    # The gaps' sum is close to ``seconds`` but not equal: scale the
    # schedule onto the window, so every request is due inside it.
    return due * (seconds * count / (count + 0.5)) / due[-1]
