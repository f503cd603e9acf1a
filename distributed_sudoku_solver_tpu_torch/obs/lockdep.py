"""Runtime lockdep witness: the dynamic half of the deadck contract.

``analysis/deadck.py`` proves the lock-acquisition graph *statically*
(every edge the source can take, checked against the declared hierarchy
in ``analysis/manifest.py``); this module is the runtime twin — the same
split as layerck/simnet and jaxck/the retrace guard.  Every lock in the
repo is created through the factories here (``named_lock`` /
``named_rlock`` / ``named_condition``) with its manifest identity
(``manifest.LOCK_RANKS``), and when a :class:`LockWitness` is installed:

* each thread's acquisition stack is tracked (re-entrant RLock
  acquisitions are recognized and excluded — re-entry is not ordering);
* every *new* ordered pair (held -> acquired) lands in one process-wide
  observed graph, dumpable as a ``--json`` artifact that tier-1
  cross-checks against deadck's predicted graph (an observed edge the
  static half didn't predict is a deadck bug — jaxck's golden
  discipline applied to concurrency);
* an acquisition that **violates the declared hierarchy** (rank order +
  ``manifest.LOCK_EDGE_DECLARED`` exceptions) or that **forms a cycle**
  with the edges already observed raises :class:`LockOrderError` at the
  moment it happens — in the thread that would have deadlocked, with
  both stacks' names in the message — and is recorded on
  ``violations`` so a raise swallowed by a daemon thread's catch-all
  still fails the test at teardown (the simnet purity-guard pattern).

**Hot-path contract** (the faults/trace/slo seam, pinned by the
explode-microcheck in tests/test_deadck.py): with no witness installed,
``acquire``/``release`` on a named lock cost ONE module-global read and
one branch over the raw ``threading`` primitive — no allocation, no
thread-local touch, no clock read.  Production never pays for the
witness it is not running.

Import discipline: stdlib only at module import.  The hierarchy is read
lazily inside :func:`manifest_witness` from ``obs/lock_manifest.py``, the
port's copy of the JAX package's ``analysis/manifest.py`` lock tables
(the port has no ``analysis`` package).
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Dict, List, Optional, Tuple


class LockOrderError(RuntimeError):
    """An acquisition that the declared lock hierarchy forbids (or that
    closes a cycle in the observed order graph) — raised *before* the
    offending acquire blocks, in the thread that would have deadlocked."""


class _Named:
    """Proxy over a raw ``threading`` lock carrying its manifest name.

    The disabled path is the contract: ``_WITNESS`` is read once; when
    ``None`` the call forwards straight to the raw primitive."""

    __slots__ = ("_real", "name", "reentrant")

    def __init__(self, real, name: str, reentrant: bool = False):
        self._real = real
        self.name = name
        self.reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        w = _WITNESS
        if w is None:
            return self._real.acquire(blocking, timeout)
        return w.acquire(self, blocking, timeout)

    def release(self) -> None:
        w = _WITNESS
        self._real.release()
        if w is not None:
            w.released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._real.locked()

    # -- threading.Condition integration ------------------------------------
    # Condition(lock) picks these up by hasattr at construction; without
    # them a re-entrantly-held RLock would be released one level instead
    # of fully around a wait().  The witness bookkeeping mirrors the real
    # state: a fully-released lock leaves the held stack, the re-acquire
    # after the wait re-enters it (no edge recording on the restore — a
    # condition re-acquire is wait protocol, not a new ordering decision,
    # and the original acquisition already recorded the edges).
    def _release_save(self):
        w = _WITNESS
        depth = w.release_all(self) if w is not None else 0
        if hasattr(self._real, "_release_save"):
            return (self._real._release_save(), depth)
        self._real.release()
        return (None, depth)

    def _acquire_restore(self, state) -> None:
        real_state, depth = state if isinstance(state, tuple) else (state, 1)
        if real_state is not None and hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(real_state)
        else:
            self._real.acquire()
        w = _WITNESS
        if w is not None:
            # Re-push the pre-wait depth (a witness armed mid-wait saw no
            # release_all; max(1, 0) keeps the stack at least honest).
            w.restored(self, depth)

    def _is_owned(self) -> bool:
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<named-{type(self._real).__name__} {self.name!r}>"


def named_lock(name: str) -> _Named:
    """A ``threading.Lock`` carrying its ``manifest.LOCK_RANKS`` identity."""
    return _Named(threading.Lock(), name)


def named_rlock(name: str) -> _Named:
    """A ``threading.RLock`` twin; re-entrant acquisitions are recognized
    by the witness and never recorded as ordering edges."""
    return _Named(threading.RLock(), name, reentrant=True)


def named_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` whose underlying (R)Lock is named —
    ``wait``'s release/re-acquire round-trips keep the witness stack
    honest through the ``_release_save``/``_acquire_restore`` seam."""
    return threading.Condition(named_rlock(name))


class LockWitness:
    """Process-wide acquisition recorder + hierarchy referee.

    ``ranks`` maps lock name -> hierarchy level (acquire strictly
    *upward*: holding A you may take B iff rank[A] < rank[B]);
    ``declared`` maps (held, acquired) -> reason for the blessed
    exceptions (the slo burn-dump re-entrancy family).  Both default to
    the manifest via :func:`install`.  ``strict`` raises on violations
    (they are *always* recorded)."""

    def __init__(
        self,
        ranks: Optional[Dict[str, int]] = None,
        declared: Optional[Dict[Tuple[str, str], str]] = None,
        strict: bool = True,
    ):
        self.ranks = dict(ranks or {})
        self.declared = dict(declared or {})
        self.strict = strict
        self._tls = threading.local()
        # Bookkeeping lock: a RAW primitive on purpose — the witness must
        # never recurse into itself, and it calls nothing while held.
        self._mu = threading.Lock()
        self._edges: set = set()  # (held, acquired) pairs observed
        self._succ: Dict[str, set] = {}  # adjacency over _edges
        self.violations: List[dict] = []
        self.acquisitions = 0  # distinct (non-reentrant) lock entries seen

    # -- per-thread stack ----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- the acquisition referee --------------------------------------------
    def acquire(self, lk: _Named, blocking: bool, timeout: float):
        st = self._stack()
        reentrant = any(e is lk for e in st)
        if reentrant and not lk.reentrant:
            # Re-acquiring a plain Lock this thread already holds: a
            # guaranteed self-deadlock the hierarchy cannot see (the
            # edge would be a self-edge).  Raise BEFORE blocking forever.
            rec = {
                "edge": [lk.name, lk.name],
                "problem": "self-deadlock: re-acquiring a non-reentrant "
                "lock already held by this thread",
            }
            with self._mu:
                self.violations.append(rec)
            if self.strict:
                raise LockOrderError(
                    f"self-deadlock acquiring {lk.name!r}: this thread "
                    "already holds it and it is not an RLock"
                )
        if not reentrant:
            held = {e.name for e in st}
            held.discard(lk.name)
            for h in held:
                self._check_edge(h, lk.name)
        ok = self._real_acquire(lk, blocking, timeout)
        if ok:
            st.append(lk)
            if not reentrant:
                with self._mu:
                    self.acquisitions += 1
        return ok

    @staticmethod
    def _real_acquire(lk: _Named, blocking: bool, timeout: float):
        return lk._real.acquire(blocking, timeout)

    def released(self, lk: _Named) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lk:
                del st[i]
                return
        # Acquired before install (or on another witness): tolerated.

    def release_all(self, lk: _Named) -> int:
        st = self._stack()
        n = sum(1 for e in st if e is lk)
        st[:] = [e for e in st if e is not lk]
        return n

    def restored(self, lk: _Named, n: int = 1) -> None:
        st = self._stack()
        for _ in range(max(1, n)):
            st.append(lk)

    # -- graph maintenance ---------------------------------------------------
    def _check_edge(self, a: str, b: str) -> None:
        if (a, b) in self._edges:  # the hot de-dupe: one set lookup
            return
        with self._mu:
            if (a, b) in self._edges:
                return
            problem = self._problem_locked(a, b)
            self._edges.add((a, b))
            self._succ.setdefault(a, set()).add(b)
        if problem is not None:
            rec = {"edge": [a, b], "problem": problem}
            with self._mu:
                self.violations.append(rec)
            if self.strict:
                raise LockOrderError(
                    f"lock-order violation acquiring {b!r} while holding "
                    f"{a!r}: {problem} (declare the edge in "
                    "analysis/manifest.LOCK_EDGE_DECLARED with a reason, "
                    "or fix the nesting)"
                )

    def _problem_locked(self, a: str, b: str) -> Optional[str]:
        # Cycle first: a->b closes one iff b already reaches a.
        if self._reaches_locked(b, a):
            return "closes a cycle in the observed acquisition graph"
        if (a, b) in self.declared:
            return None
        ra, rb = self.ranks.get(a), self.ranks.get(b)
        if ra is None or rb is None:
            unknown = a if ra is None else b
            return f"lock {unknown!r} is not in manifest.LOCK_RANKS"
        if ra >= rb:
            return (
                f"hierarchy violation: rank[{a}]={ra} >= rank[{b}]={rb} "
                "(locks must be acquired strictly rank-upward)"
            )
        return None

    def _reaches_locked(self, src: str, dst: str) -> bool:
        seen = set()
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(self._succ.get(n, ()))
        return False

    # -- read surface --------------------------------------------------------
    def graph(self) -> List[Tuple[str, str]]:
        with self._mu:
            return sorted(self._edges)

    def report(self) -> dict:
        with self._mu:
            return {
                "edges": [list(e) for e in sorted(self._edges)],
                "violations": list(self.violations),
                "acquisitions": int(self.acquisitions),
            }

    def dump_json(self, path: str) -> None:
        """The cross-check artifact: deterministic (sorted) JSON of the
        observed graph, for diffing against deadck's predicted edges."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)


# -- the process-wide seam ----------------------------------------------------
#
# Mirrors faults/trace/slo/compilewatch: one module global, read once per
# acquire.  Tests arm a witness around the whole tier-1 session (autouse
# conftest hook); production runs with None installed.

_WITNESS: Optional[LockWitness] = None


def manifest_witness(strict: bool = True) -> LockWitness:
    """A witness loaded with the lock hierarchy (``obs/lock_manifest.py``,
    the port's copy of the JAX package's ``analysis/manifest.py`` tables)."""
    from distributed_sudoku_solver_tpu_torch.obs import lock_manifest

    return LockWitness(
        ranks=dict(lock_manifest.LOCK_RANKS),
        declared=dict(lock_manifest.LOCK_EDGE_DECLARED),
        strict=strict,
    )


def install(witness: Optional[LockWitness]) -> None:
    global _WITNESS
    _WITNESS = witness


def active() -> Optional[LockWitness]:
    return _WITNESS


@contextlib.contextmanager
def installed(witness: LockWitness):
    """Scope a witness over a block (tests): always restores the previous
    one — tier-1 runs a session-wide witness, and a test scoping its own
    must not disarm the session on exit."""
    prev = _WITNESS
    install(witness)
    try:
        yield witness
    finally:
        install(prev)
