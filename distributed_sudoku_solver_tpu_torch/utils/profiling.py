"""Bounded sample windows (``StatWindow``), from the JAX package's ``utils/profiling.py``.

:class:`StatWindow` keeps a bounded ring of recent samples (per-job
latencies, batch sizes) with a percentile readout.  The JAX module's
device-trace helpers (``device_trace`` and the serving profile window,
which wrap ``jax.profiler``) are not part of this copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.obs import lockdep


class StatWindow:
    """Bounded ring buffer of numeric samples with percentile snapshots.

    Unit-agnostic (latencies in seconds, batch sizes in jobs, ...).
    Single-writer friendly: the device loop records; any thread reads a
    consistent-enough snapshot — readers tolerate torn windows, the same
    contract as the engine's counters.
    """

    def __init__(self, capacity: int = 1024):
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._n = 0
        self._lock = lockdep.named_lock("utils.statwindow")  # lockck: name(utils.statwindow)

    def record(self, value: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = value
            self._n += 1

    def snapshot(self) -> Optional[dict]:
        """None if empty, else ``{"count", "total", "p50", "p95", "p99"}``:
        percentiles over the current window (its size is ``count``) and the
        lifetime sample count as ``total``."""
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return None
            window = self._buf[:n].copy()
            total = self._n
        p50, p95, p99 = np.percentile(window, [50, 95, 99])
        return {
            "count": int(n),
            "total": int(total),
            "p50": float(p50),
            "p95": float(p95),
            "p99": float(p99),
        }
