"""Front door: the three tiers a board crosses before it may cost a device
dispatch (a copy of the JAX package's ``serving/frontdoor``; host numpy and
stdlib only, so the canonical digests and cache snapshots of the two
packages are interchangeable).

At millions-of-users scale, `/solve` traffic is overwhelmingly *easy*
(42040/65536 of the corpus solves by propagation alone) and heavily
*repeated* (published puzzles are shared), yet before this layer every
request paid a device dispatch.  The front door sits on the engine's
submit seam (``SolverEngine(frontdoor=...)``) and routes each board
through, in order:

1. **Result cache** (``cache.py``): a bounded content-addressed store
   keyed on the board's symmetry-canonical form (``canonical.py`` — digit
   relabeling + row/column permutations within bands/stacks + band/stack
   permutation + transpose), so any of the ~3x10^6 equivalents of a
   published puzzle keys to ONE entry.  Hits are O(µs) host lookups; the
   stored canonical solution is mapped back to the submitted frame via
   the request's own inverse transform.  Proven-unsat boards are cached
   as negative entries.
2. **Difficulty probe** (``router.py``): one bounded propagation-only
   pass (host numpy, no jax, no dispatch).  Boards it solves outright
   answer immediately; boards it proves contradictory answer 422; the
   rest are scored by remaining branching slack.
3. **Router**: easy boards go to the native C++ DFS via the
   ``serving/portfolio.py`` racer seam (``race_native`` — first verdict
   wins, with a delayed device fallback so a misjudged board never
   hangs); the hard tail goes to resident/static flights exactly as
   before.

Every tier is observable: per-route ``LatencyHistogram``s ride the
engine's ``hist`` keyspace (cluster rollup via ``obs/agg.py`` for free),
hit/dup/route counters export as the ``/metrics`` ``frontdoor`` section,
and ``frontdoor.cache``/``frontdoor.probe``/``frontdoor.route`` trace
spans ride the trace recorder.  ``SolverEngine(frontdoor=None)`` keeps
the direct path; ``count_all``/portfolio/``solve_batch`` requests bypass the cache
by construction (per-job configs skip the seam — enumeration and bulk
are not memoizable by a single canonical entry).
"""

from distributed_sudoku_solver_tpu_torch.serving.frontdoor.cache import ResultCache
from distributed_sudoku_solver_tpu_torch.serving.frontdoor.canonical import (
    Transform,
    apply_transform,
    canonicalize,
    restore_solution,
)
from distributed_sudoku_solver_tpu_torch.serving.frontdoor.router import (
    FrontDoor,
    FrontDoorConfig,
    probe_propagate,
)

__all__ = [
    "FrontDoor",
    "FrontDoorConfig",
    "ResultCache",
    "Transform",
    "apply_transform",
    "canonicalize",
    "probe_propagate",
    "restore_solution",
]
