"""Opt-in ordering trace: branch-training examples + route/wall outcomes.

The learned pieces of ROADMAP #4 train **offline** from data this module
journals during normal serving:

* **route outcomes** — per job: the front door's probe score, the route it
  took (cache / probe-solved / native / device), the wall time, and the
  device node count when the job went to a flight.  ``benchmarks/
  train_ordering.py fit-threshold`` replays these to pick the
  ``easy_score`` routing threshold that actually separates the
  probe-solvable tier from the device tier, replacing the fixed default
  (``serving/frontdoor/learn.py``).
* **branch examples** — per solved grid (sampled): the grid itself, so the
  host-side replay (``ops/ordering.py:record_branch_examples``) can
  journal every (state, chosen-cell, subtree-nodes) decision off the hot
  path.  The device kernels never journal per-branch data — that would be
  a host sync per node; recording the *grid* costs one line of JSONL.

Like ``obs/trace.py``, production runs with no recorder installed and
every hook site pays one global read + one branch.  The recorder appends
JSONL (one self-describing event per line, ``{"kind": ...}``) so a crash
loses at most one line and training can stream the file.  Layering: obs
is a closed layer importable from serving — the front door cannot import
ops, so the hooks live here and the ops-side replay reads the file.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Optional

from distributed_sudoku_solver_tpu_torch.obs import lockdep


class OrderTraceRecorder:
    """Append-only JSONL journal of route outcomes and sampled grids.

    ``sample_grids``: record every k-th resolved grid as a branch-example
    source (1 = every grid).  Grids serialize as the flat digit string the
    cluster wire format uses — 81 chars at 9x9, '0' for empty."""

    def __init__(self, path: str, sample_grids: int = 1):
        self.path = path
        self.sample_grids = max(1, int(sample_grids))
        self._lock = lockdep.named_lock("obs.ordertrace")  # lockck: name(obs.ordertrace)
        self._fh = open(path, "a", encoding="utf-8")  # lockck: guard(_lock)
        self._grid_seen = 0  # lockck: guard(_lock)
        self.events = 0  # lockck: guard(_lock)

    def _emit_locked(self, event: dict) -> None:
        self._fh.write(json.dumps(event, sort_keys=True) + "\n")
        self._fh.flush()
        self.events += 1

    def route(
        self,
        uuid: str,
        score: int,
        empties: int,
        route: str,
        wall_ms: float,
        solved: bool,
        unsat: bool,
        nodes: int = 0,
    ) -> None:
        """One resolved job: what the probe saw and how the route paid off."""
        with self._lock:
            self._emit_locked(
                {
                    "kind": "route",
                    "uuid": uuid,
                    "score": int(score),
                    "empties": int(empties),
                    "route": route,
                    "wall_ms": round(float(wall_ms), 3),
                    "solved": bool(solved),
                    "unsat": bool(unsat),
                    "nodes": int(nodes),
                }
            )

    def grid(self, grid, n: int) -> None:
        """Sampled branch-example source; ``grid`` is any [n, n] int array."""
        with self._lock:
            self._grid_seen += 1
            if (self._grid_seen - 1) % self.sample_grids:
                return
            flat = "".join(str(int(grid[r][c])) for r in range(n) for c in range(n))
            self._emit_locked({"kind": "grid", "n": n, "grid": flat})

    def close(self) -> None:
        with self._lock:
            self._fh.close()


def read_events(path: str) -> list:
    """All events in a journal file (skipping any torn final line)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail line from a crash mid-write
    return out


# -- the process-wide seam ----------------------------------------------------

_active: Optional[OrderTraceRecorder] = None


def install(recorder: Optional[OrderTraceRecorder]) -> None:
    global _active
    _active = recorder


def active() -> Optional[OrderTraceRecorder]:
    return _active


@contextlib.contextmanager
def installed(recorder: OrderTraceRecorder):
    """Scope a recorder over a block (tests): always uninstalls."""
    install(recorder)
    try:
        yield recorder
    finally:
        install(None)
        recorder.close()
