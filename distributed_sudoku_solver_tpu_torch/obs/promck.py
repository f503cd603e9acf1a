"""Prometheus exposition lint (``promck``): traceck's sibling for the
``/metrics?format=prometheus`` surface.

``obs/prom.py`` (and now the histogram/SLO renderers layered on it)
promises well-formed text exposition; this module is the executable form
of that promise, used by the tests over the LIVE endpoint output and
runnable standalone::

    python -m distributed_sudoku_solver_tpu_torch.obs.promck metrics.txt

Checks (returns a list of error strings; empty = well-formed):

* every non-comment line parses as ``name{labels} value`` with a valid
  metric name, strictly-escaped label values (raw ``"``, newline, or a
  stray backslash inside a label value is a scrape-breaking bug), and a
  float-parseable value;
* no duplicate series: the same ``(name, label set)`` emitted twice makes
  Prometheus reject the whole scrape;
* no duplicate label names within one series;
* histogram families (``*_bucket`` with an ``le`` label): ``le`` values
  parse, cumulative counts are non-decreasing in ``le`` order, and the
  family ends with an ``le="+Inf"`` bucket.

Exit codes follow the *ck-family contract (``obs/exitcodes.py``): 0
clean, 1 findings, 2 internal/usage error (bad invocation, unreadable
input).  Stdlib only.
"""

from __future__ import annotations

import math
import re
import sys
from typing import List, Union

from distributed_sudoku_solver_tpu_torch.obs.exitcodes import (
    EXIT_CLEAN,
    EXIT_INTERNAL,
    EXIT_VIOLATIONS,
)

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LINE = re.compile(rf"^({_NAME})(?:\{{(.*)\}})? (\S+)$")
# One label, strictly escaped: only \\ , \" and \n escapes; no raw quote,
# backslash, or newline inside the value.
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\\\|\\"|\\n|[^"\\])*)"')


def _parse_labels(raw: str, where: str, errors: List[str]):
    """-> list[(name, value)] or None on a malformed label block."""
    labels = []
    pos = 0
    while pos < len(raw):
        m = _LABEL.match(raw, pos)
        if m is None:
            errors.append(f"{where}: malformed/unescaped labels at {raw[pos:]!r}")
            return None
        labels.append((m.group(1), m.group(2)))
        pos = m.end()
        if pos < len(raw):
            if raw[pos] != ",":
                errors.append(
                    f"{where}: malformed labels (expected ',') at {raw[pos:]!r}"
                )
                return None
            pos += 1
    return labels


def _parse_value(s: str):
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    try:
        return float(s)
    except ValueError:
        return None


def check_text(text: str) -> List[str]:
    """Validate one exposition body; returns error strings."""
    errors: List[str] = []
    seen: set = set()
    # (bucket family key) -> list of (le, cumulative count, line no)
    families: dict = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line or line.startswith("#"):
            continue
        where = f"line {ln}"
        m = _LINE.match(line)
        if m is None:
            errors.append(f"{where}: unparseable: {line!r}")
            continue
        name, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(raw_labels or "", where, errors)
        if labels is None:
            continue
        lnames = [k for k, _ in labels]
        if len(lnames) != len(set(lnames)):
            errors.append(f"{where}: duplicate label name in {line!r}")
            continue
        value = _parse_value(raw_value)
        if value is None:
            errors.append(f"{where}: unparseable value {raw_value!r}")
            continue
        series = (name, tuple(sorted(labels)))
        if series in seen:
            errors.append(f"{where}: duplicate series {name}{dict(labels)}")
        seen.add(series)
        if name.endswith("_bucket"):
            le = dict(labels).get("le")
            if le is None:
                errors.append(f"{where}: {name} bucket without an 'le' label")
                continue
            le_v = _parse_value(le)
            if le_v is None:
                errors.append(f"{where}: unparseable le {le!r}")
                continue
            key = (name, tuple(sorted(p for p in labels if p[0] != "le")))
            families.setdefault(key, []).append((le_v, value, ln))
    for (name, labels), buckets in families.items():
        buckets.sort(key=lambda b: b[0])
        if not buckets or not math.isinf(buckets[-1][0]):
            errors.append(
                f"{name}{dict(labels)}: histogram family missing an "
                'le="+Inf" bucket'
            )
        prev = None
        for le_v, count, ln in buckets:
            if prev is not None and count < prev:
                errors.append(
                    f"line {ln}: non-monotone le buckets in {name}: "
                    f"count {count:g} at le={le_v:g} after {prev:g}"
                )
            prev = count
    return errors


def _load(path: str) -> str:
    """The one read path, shared by check_file and main so the two cannot
    drift (the exit-code split lives at the callers)."""
    with open(path) as f:
        return f.read()


def check_file(path: str) -> List[str]:
    try:
        text = _load(path)
    except OSError as e:
        return [f"{path}: unreadable: {e}"]
    return check_text(text)


def main(argv: Union[List[str], None] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(
            "usage: python -m distributed_sudoku_solver_tpu_torch.obs.promck "
            "<metrics.txt>",
            file=sys.stderr,
        )
        return EXIT_INTERNAL
    # Unreadable input is the tool failing to check, not the exposition
    # failing the check (exit-code contract, module docstring).
    try:
        text = _load(argv[0])
    except OSError as e:
        print(f"promck: {argv[0]}: unreadable: {e}", file=sys.stderr)
        return EXIT_INTERNAL
    errors = check_text(text)
    if errors:
        for e in errors:
            print(f"promck: {e}", file=sys.stderr)
        return EXIT_VIOLATIONS
    n = sum(
        1
        for ln in text.splitlines()
        if ln.strip() and not ln.startswith("#")
    )
    print(f"promck: OK ({n} series)")
    return EXIT_CLEAN


if __name__ == "__main__":
    raise SystemExit(main())
