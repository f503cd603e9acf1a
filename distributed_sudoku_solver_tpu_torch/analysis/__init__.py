"""Static invariant linter of the port: its contracts, proved on every line.

The JAX package's ``analysis`` rules, pointed at this package's tree and
its own manifest (``analysis/manifest.py``).  Five AST-based fast rules
plus one opt-in kernel rule behind one runner::

    python -m distributed_sudoku_solver_tpu_torch.analysis [--json] [--rule R]
                                                           [--strict-waivers]
    python -m distributed_sudoku_solver_tpu_torch.analysis --rule kernelck \\
                                                           [--update-golden]

* **layerck** — the import-layering manifest (``manifest.LAYERS``): the
  closed layers (``obs/``, ``serving/faults.py``, ``cluster/wire.py``,
  ``cluster/simnet.py``, ``cluster/dht/``, the front door, brownout, the
  journal, this package) import stdlib and their declared siblings only;
  ``ops``/``models``/``parallel``/``utils``/``native``/``probes`` never
  import ``serving``/``cluster``.
* **clockck** — bare ``time.time``/``time.monotonic``/``time.sleep``/
  ``datetime.now`` calls banned in ``cluster/``, ``serving/``, ``obs/``
  outside the declared seams.
* **syncck** — in torch terms: in the serving hot loops, ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``np.asarray``
  of a tensor, ``bool()``/``int()``/``float()`` of a tensor and
  ``torch.cuda.synchronize`` / ``Event.synchronize`` go through the
  ``host_fetch`` seam or prove their operand host-side.
* **lockck** — attributes declared ``# lockck: guard(_lock)`` are only
  written under ``with <base>._lock:`` (or in ``*_locked`` helpers).
* **deadck** — every lock is created through ``obs.lockdep.named_*``
  with a ``# lockck: name(<tier>.<name>)`` identity; the whole-tree
  lock-acquisition graph is rank-upward in ``manifest.LOCK_RANKS`` (from
  ``obs/lock_manifest.py``) or declared; writes reachable from two thread
  roots are guarded.
* **kernelck** (opt-in; imports torch lazily) — the port's counterpart
  of ``jaxck``: the kernel libraries' build digests against
  ``analysis/goldens/kernelck.json``, and the dtypes of the serving
  advance programs (see ``analysis/kernelck.py`` for what carries over
  from jaxck and what does not).

Waiver grammar (all rules): a trailing ``# <rule>: allow(<reason>)`` on
the flagged line, or on the enclosing ``def`` line.  The reason is
mandatory; a waiver whose rule no longer fires is reported stale
(``--strict-waivers`` makes that exit 1).

Exit codes are the *ck-family contract (``obs/exitcodes.py``): 0 clean,
1 violations, 2 internal/usage error.  The default lane never imports
torch, jax or the JAX package (tests/test_torch_analysis.py pins it).
"""

from distributed_sudoku_solver_tpu_torch.analysis.common import (  # noqa: F401
    ALL_RULES,
    LAZY_RULES,
    RULES,
    Finding,
)
from distributed_sudoku_solver_tpu_torch.obs.exitcodes import (  # noqa: F401
    EXIT_CLEAN,
    EXIT_INTERNAL,
    EXIT_VIOLATIONS,
)
