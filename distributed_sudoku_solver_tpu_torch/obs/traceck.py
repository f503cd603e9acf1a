"""Chrome-trace JSON validator (``traceck``): the tooling half of the
trace plane's contract.

A copy of the JAX package's ``obs/traceck.py`` with its imports pointed at
this package.  ``TraceRecorder.perfetto`` (and ``GET
/trace?format=perfetto``, built on it) promises valid Chrome-trace JSON
with monotone spans; this module is the executable form of that promise,
used by the tests and ``chip_smoke.py`` and runnable standalone::

    python -m distributed_sudoku_solver_tpu_torch.obs.traceck trace.json

Checks (returns a list of error strings; empty = well-formed):

* top level is an object with a ``traceEvents`` list;
* every event is an object with string ``name``, ``ph`` in the emitted
  set (``X`` complete, ``M`` metadata), integer ``pid``/``tid``;
* ``X`` events carry numeric ``ts >= 0`` and ``dur >= 0``;
* spans are monotone: within each ``(pid, tid)`` lane, ``X`` events'
  ``ts`` never decreases (Perfetto renders out-of-order slices as a
  corrupt-looking track).

Exit codes follow the *ck-family contract (``obs/exitcodes.py``): 0
clean, 1 findings, 2 internal/usage error (bad invocation, unreadable
input).  Stdlib only.
"""

from __future__ import annotations

import json
import sys
from typing import List, Union

from distributed_sudoku_solver_tpu_torch.obs.exitcodes import (
    EXIT_CLEAN,
    EXIT_INTERNAL,
    EXIT_VIOLATIONS,
)

_ALLOWED_PH = {"X", "M", "i", "I"}


def check(doc) -> List[str]:
    """Validate a parsed Chrome-trace document; returns error strings."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    last_ts: dict = {}  # (pid, tid) -> last X-event ts
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"{where}: missing/empty 'name'")
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            errors.append(f"{where}: bad 'ph' {ph!r}")
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        if not isinstance(pid, int) or not isinstance(tid, int):
            errors.append(f"{where}: pid/tid must be integers")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: bad 'ts' {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: bad 'dur' {dur!r}")
            lane = (pid, tid)
            if ts < last_ts.get(lane, float("-inf")):
                errors.append(
                    f"{where}: non-monotone ts {ts} after "
                    f"{last_ts[lane]} in lane pid={pid} tid={tid}"
                )
            else:
                last_ts[lane] = ts
    return errors


def _load(path: str):
    """The one read-and-parse path, shared by check_file and main so the
    two cannot drift (the exit-code split lives at the callers)."""
    with open(path) as f:
        return json.load(f)


def check_file(path: str) -> List[str]:
    try:
        doc = _load(path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable or not JSON: {e}"]
    return check(doc)


def main(argv: Union[List[str], None] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m distributed_sudoku_solver_tpu_torch.obs.traceck "
              "<trace.json>", file=sys.stderr)
        return EXIT_INTERNAL
    # Unreadable input is the tool failing to check, not the trace
    # failing the check (exit-code contract, module docstring).
    try:
        doc = _load(argv[0])
    except (OSError, json.JSONDecodeError) as e:
        print(f"traceck: {argv[0]}: unreadable or not JSON: {e}",
              file=sys.stderr)
        return EXIT_INTERNAL
    errors = check(doc)
    if errors:
        for e in errors:
            print(f"traceck: {e}", file=sys.stderr)
        return EXIT_VIOLATIONS
    n = len(doc.get("traceEvents", []))
    print(f"traceck: OK ({n} events)")
    return EXIT_CLEAN


if __name__ == "__main__":
    raise SystemExit(main())
