"""The *ck tool family's shared exit-code contract.

``obs/traceck.py``, ``obs/promck.py`` and the source linter
(``analysis/``, ``python -m distributed_sudoku_solver_tpu_torch.analysis``)
share one convention; this module is the single documented scheme,
asserted by their tests:

* ``EXIT_CLEAN`` (0)      — input checked, no findings.
* ``EXIT_VIOLATIONS`` (1) — the input was checkable and has findings
  (malformed exposition lines, non-monotone spans, invariant
  violations).
* ``EXIT_INTERNAL`` (2)   — the tool could not do its job: bad usage,
  unreadable input, checker crash.  CI treats 1 as "fix the code under
  check" and 2 as "fix the invocation/tool".

Stdlib-only, import-anywhere (obs's closed layer allows only obs
siblings, which is why the family's contract lives here rather than in
``analysis/``).
"""

EXIT_CLEAN = 0
EXIT_VIOLATIONS = 1
EXIT_INTERNAL = 2
