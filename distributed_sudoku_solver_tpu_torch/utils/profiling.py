"""Device traces and bounded sample windows, from the JAX package's ``utils/profiling.py``.

* :func:`device_trace` wraps ``torch.profiler`` (the JAX module wraps
  ``jax.profiler``): a Chrome-trace JSON of the host and, on a card, the
  device timeline for any code region, written into ``logdir``;
* :func:`start_profile_window` is its serving wire-up (``POST /profile``):
  one bounded capture window at a time, closed by a daemon timer, so a
  node is never left tracing because a client forgot a second request;
* :class:`StatWindow` keeps a bounded ring of recent samples (per-job
  latencies, batch sizes) with a percentile readout.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from distributed_sudoku_solver_tpu_torch.obs import lockdep

_LOG = logging.getLogger(__name__)


def _profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _stop_and_export(prof: torch.profiler.profile, logdir: str) -> None:
    """Stop ``prof`` and write its trace into ``logdir``; a failure to stop
    or export is logged, not raised (a timer thread has no caller)."""
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    except (RuntimeError, OSError) as e:
        _LOG.error("[profiling] stopping the trace into %s failed: %r", logdir, e)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the region into
    ``logdir/trace.json``.  Usage::

        with device_trace("/tmp/trace"):
            solve_batch(...)  # traced region
    """
    os.makedirs(logdir, exist_ok=True)
    prof = _profiler()
    prof.start()
    try:
        yield prof
    finally:
        _stop_and_export(prof, logdir)


# -- bounded serving profile window (POST /profile) ---------------------------

_window_lock = lockdep.named_lock("utils.profile_window")  # lockck: name(utils.profile_window)
_window: Optional[threading.Thread] = None  # the open window's thread


def profile_window_active() -> bool:
    with _window_lock:
        return _window is not None


def start_profile_window(
    logdir: str, secs: float, on_close: Optional[Callable[[], None]] = None
) -> bool:
    """Start a ``torch.profiler`` capture into ``logdir`` that stops itself
    after ``secs``, then calls ``on_close`` (the CLI's ``--profile-secs``
    prints a line).  False if a window is already open (the caller answers
    409); the profiler's own error propagates if the start fails (another
    profiler already running in the process).

    The window lives on a thread of its own, which starts the profiler,
    waits ``secs`` and stops it: torch's profiler must be stopped on the
    thread that started it."""
    global _window
    with _window_lock:
        if _window is not None:
            return False
        os.makedirs(logdir, exist_ok=True)
        started = threading.Event()
        failed: list = []

        def run() -> None:
            global _window
            prof = _profiler()
            try:
                prof.start()
            except RuntimeError as e:
                failed.append(e)
                started.set()
                return
            started.set()
            threading.Event().wait(secs)
            _stop_and_export(prof, logdir)
            with _window_lock:
                _window = None
            if on_close is not None:
                on_close()

        thread = threading.Thread(target=run, daemon=True, name="profile-window")
        thread.start()
        started.wait()
        if failed:
            raise failed[0]
        _window = thread
    return True


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
