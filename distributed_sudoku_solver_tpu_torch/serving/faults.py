"""Self-healing serving, layer by layer: fault taxonomy, deterministic
injection, recovery policy, and the resident-flight circuit breaker.

The reference system's headline capability is fault tolerance — heartbeats,
failure detection, task re-execution (``/root/reference/DHT_Node.py``) —
and the cluster layer reproduces it at node granularity.  This module
brings the same discipline INSIDE one node's serving stack, where until
round 9 every device-side failure was terminal: a dispatch exception
failed its whole batch, and a failed resident flight closed admission
forever.  Real accelerator fleets see transient faults (preemption,
co-tenant OOM, runtime hiccups) as routine events, not fatal ones.

Four pieces, all host-side (no shared-op HLO changes — the tier-1 XLA
cache stays warm):

* **Taxonomy** (:func:`classify` / :func:`classify_message` /
  :func:`is_oom`): transient vs permanent.  Transient errors (OOM,
  preemption, runtime aborts, tripped RPC deadlines, anything unknown)
  are worth a bounded retry; permanent ones (``ValueError``-shaped
  programming/config errors, anything tagged ``[permanent]``) fail fast.
  Unknown errors default to *transient* — the per-job retry budget bounds
  the optimism, and retrying a deterministic failure three times is
  cheaper than failing a recoverable job once.
* **Deterministic injection plane** (:class:`FaultSchedule` /
  :class:`FaultInjector`): a seeded, schedule-driven injector wrapping the
  serving dispatch/fetch seams (``faults.fire(site)`` calls in
  ``serving/engine.py``, ``serving/scheduler.py``, ``ops/bulk.py``, and
  the cluster's ``_send``).  Faults are chosen purely by ``(site,
  per-site dispatch index)`` — independent of thread interleaving — so a
  schedule is bit-reproducible from its seed.  No sleeps, no sockets: a
  "delay" fault is simulated by its observable consequence (the per-sync
  RPC deadline trips) instead of wall-clock time.
* **Recovery policy** (:class:`RecoveryPolicy`): the knobs — per-job
  retry budget, rebuild cooldown, breaker thresholds — plus an injectable
  ``clock`` so breaker/cooldown transitions are testable without sleeping.
* **Circuit breaker** (:class:`CircuitBreaker`): closed → open after k
  consecutive resident-rebuild failures (admission then falls back to
  static flights), half-open after a cooldown (one rebuild attempt
  probes), closed again on the first successfully consumed chunk.

Import discipline: stdlib plus the (itself stdlib-only) ``obs.lockdep``
named-lock factory and ``ops.cuda_build.KernelError`` (a kernel that
cannot build, load or launch is permanent: no retry or fallback rung
may hide it) — the declared carve-out in ``manifest.LAYERS`` that
puts this module's two locks in the one deadck/lockdep hierarchy.
Engine, scheduler, bulk, and cluster all import this module; it must
never import them back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import re
import time
import zlib
from typing import Callable, Iterable, Optional

from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.ops.cuda_build import KernelError

# -- taxonomy -----------------------------------------------------------------

TRANSIENT = "transient"
PERMANENT = "permanent"

#: Injectable fault kinds and the wire-style status each simulates.  The
#: last two are *network link* kinds, consumed by ``cluster/simnet.py``'s
#: per-link schedules rather than the serving dispatch seams: ``drop``
#: (frame lost after bytes were written — the sender sees an
#: ambiguous-delivery WireError and its retry implies at-least-once),
#: ``dup`` (the frame is delivered twice — a redelivery the sender never
#: learns about).  ``delay`` does double duty: at a serving seam it is
#: simulated by its consequence (tripped RPC deadline), on a simnet link
#: it is a real bounded *virtual* delay, i.e. reordering.
FAULT_KINDS = ("oom", "preempt", "runtime", "delay", "permanent", "drop", "dup")

_MESSAGES = {
    # RESOURCE_EXHAUSTED-style OOM: a co-tenant ate the HBM headroom.
    "oom": "RESOURCE_EXHAUSTED: out of memory while trying to allocate "
    "frontier buffers (simulated co-tenant OOM)",
    # Preemption: the runtime revoked the device mid-dispatch.
    "preempt": "UNAVAILABLE: device preempted by a higher-priority job "
    "(simulated preemption)",
    # Runtime hiccup: the program aborted for no reason of ours.
    "runtime": "INTERNAL: device program aborted (simulated runtime error)",
    # Delay: simulated by its consequence — the per-sync RPC deadline
    # trips — because a real sleep would make tests wall-clock-bound.
    "delay": "DEADLINE_EXCEEDED: dispatch exceeded the RPC deadline "
    "(simulated slow link)",
    # Poison: a deterministic failure retries cannot cure.
    "permanent": "INVALID_ARGUMENT: poisoned dispatch (simulated) [permanent]",
    # Link kinds (cluster/simnet.py): frame lost after the connect
    # succeeded — delivery is ambiguous at the sender — and duplicate
    # delivery of a frame the sender believes it sent once.
    "drop": "UNAVAILABLE: connection reset mid-frame (simulated loss after "
    "connect; delivery ambiguous)",
    "dup": "UNAVAILABLE: frame redelivered (simulated at-least-once "
    "duplicate)",
}


class SimulatedFault(RuntimeError):
    """An injected device/wire fault.  ``transient`` drives classification
    directly; real-world exceptions go through the message heuristics."""

    def __init__(self, kind: str, site: str, index: int):
        super().__init__(f"{_MESSAGES[kind]} [site={site} #{index}]")
        self.kind = kind
        self.site = site
        self.index = index
        self.transient = kind != "permanent"


# Exception types that mean "the program/inputs are wrong", not "the world
# hiccuped": retrying cannot change the outcome.
_PERMANENT_TYPES = (
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AssertionError,
    NotImplementedError,
    KernelError,
)
# Error-string prefixes for the same judgement once an exception has been
# flattened to ``f"{type(e).__name__}: {e}"`` (engine job errors, cluster
# SOLUTION payloads).
_PERMANENT_PREFIXES = tuple(t.__name__ for t in _PERMANENT_TYPES)
# Bare "OOM" needs word boundaries: "headroom"/"zoom" must not route a
# non-allocation fault onto the lane-halving rung.
_OOM_RE = re.compile(r"RESOURCE_EXHAUSTED|OUT OF MEMORY|\bOOM\b")


def classify(exc: BaseException) -> str:
    """``'transient'`` or ``'permanent'``.  Unknown errors are transient:
    the retry budget bounds the optimism (see module docstring)."""
    if isinstance(exc, SimulatedFault):
        return TRANSIENT if exc.transient else PERMANENT
    if isinstance(exc, _PERMANENT_TYPES):
        return PERMANENT
    return classify_message(str(exc))


def classify_message(msg: Optional[str]) -> str:
    """Classify an error already flattened to a string (cluster SOLUTION
    payloads, ``run_exclusive``'s re-raised control errors)."""
    if not msg:
        return TRANSIENT
    if "[permanent]" in msg:
        return PERMANENT
    head = msg.split(":", 1)[0].strip()
    if head in _PERMANENT_PREFIXES:
        return PERMANENT
    if "INVALID_ARGUMENT" in msg:
        return PERMANENT
    return TRANSIENT


def is_oom(exc_or_msg) -> bool:
    """OOM-shaped failures get the lane-halving rung of the downgrade
    ladder: half the flight width is the one retry that attacks the cause."""
    if isinstance(exc_or_msg, SimulatedFault):
        return exc_or_msg.kind == "oom"
    return _OOM_RE.search(str(exc_or_msg).upper()) is not None


# -- recovery policy ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Host-side recovery knobs (engine + resident scheduler + breaker).

    ``clock`` exists so every time-based transition (rebuild cooldown,
    breaker open → half-open) is testable deterministically: tests inject
    a manually-advanced clock and never sleep.
    """

    max_retries: int = 3  # transient re-dispatches per job before it fails
    rebuild_cooldown_s: float = 0.25  # wait before rebuilding a failed
    #   resident flight (back-to-back rebuild storms burn the device loop)
    breaker_failures: int = 3  # consecutive rebuild failures that open the
    #   breaker (admission then deflects to static flights)
    breaker_cooldown_s: float = 2.0  # open -> half-open wait; the first
    #   admission after it is the probe rebuild
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.breaker_failures < 1:
            raise ValueError(
                f"breaker_failures must be >= 1, got {self.breaker_failures}"
            )


# -- circuit breaker ----------------------------------------------------------


class CircuitBreaker:
    """closed -> open after k consecutive failures -> half-open after a
    cooldown -> closed on the next success (or back open on failure).

    Thread contract: any thread may call any method (``allow`` runs on
    submit threads, record_* on the device loop); a single internal lock
    keeps transitions atomic.  Time comes from the policy clock only.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, policy: RecoveryPolicy):
        self.policy = policy
        self._lock = lockdep.named_lock("serving.breaker")  # lockck: name(serving.breaker)
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.transitions = 0  # state changes, for observability/tests
        self._opened_at = 0.0
        self._probe_at = 0.0  # last half-open probe grant

    def allow(self) -> bool:
        """May work be admitted?  Flips open -> half-open when the cooldown
        has elapsed — the ONE admission that sees the flip is the probe;
        later callers are denied until the probe resolves the state
        (record_success -> closed, record_failure -> back open), so a
        concurrent submit burst cannot pile jobs onto an unproven rebuild.
        A probe can die resolving NEITHER way (cancelled or
        deadline-expired before its flight consumes a chunk, or rejected
        by the admission checks after this flip) — so half-open re-grants
        one probe per cooldown window instead of wedging forever."""
        with self._lock:
            now = self.policy.clock()
            if self.state == self.OPEN:
                if now - self._opened_at >= self.policy.breaker_cooldown_s:
                    self.state = self.HALF_OPEN
                    self.transitions += 1
                    self._probe_at = now
                    return True
                return False
            if self.state == self.HALF_OPEN:
                if now - self._probe_at >= self.policy.breaker_cooldown_s:
                    self._probe_at = now
                    return True
                return False
            return True

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if (
                self.state == self.HALF_OPEN
                or self.consecutive_failures >= self.policy.breaker_failures
            ):
                if self.state != self.OPEN:
                    self.transitions += 1
                self.state = self.OPEN
                self._opened_at = self.policy.clock()

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            if self.state != self.CLOSED:
                self.state = self.CLOSED
                self.transitions += 1

    def metrics(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "transitions": self.transitions,
            }


# -- deterministic fault schedules --------------------------------------------


class FaultSchedule:
    """Pure function ``(site, per-site dispatch index) -> fault kind | None``.

    Two constructors: :meth:`at` pins exact faults to exact dispatch
    indices (unit tests, poison scenarios), :meth:`seeded` draws a
    per-(site, index) Bernoulli from a seed (chaos soaks).  Both are
    independent of call interleaving: the decision for dispatch #7 of
    ``engine.advance`` is the same whatever other sites did in between,
    so a multi-threaded run is as reproducible as a serial one.
    """

    def __init__(self, fn: Callable[[str, int], Optional[str]]):
        self._fn = fn

    @classmethod
    def at(cls, plan: dict) -> "FaultSchedule":
        """``plan``: ``{site: {index: kind}}`` — explicit, exact."""
        for site, hits in plan.items():
            for idx, kind in hits.items():
                if kind not in FAULT_KINDS:
                    raise ValueError(f"unknown fault kind {kind!r} at {site}#{idx}")
        return cls(lambda site, idx: plan.get(site, {}).get(idx))

    @classmethod
    def seeded(
        cls,
        seed: int,
        rate: float,
        kinds: Iterable[str] = ("oom", "preempt", "runtime", "delay"),
        sites: Optional[Iterable[str]] = None,
    ) -> "FaultSchedule":
        """Bernoulli(rate) per (site, index), kind drawn uniformly from
        ``kinds``; ``sites`` restricts injection to those seams.  The draw
        is keyed on (seed, crc32(site), index) packed into one integer
        seed for a stdlib ``random.Random`` — order-independent,
        bit-reproducible, and free of hash randomization (ints only)."""
        kinds = tuple(kinds)
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        site_set = None if sites is None else frozenset(sites)

        def fn(site: str, idx: int) -> Optional[str]:
            if site_set is not None and site not in site_set:
                return None
            key = (
                ((seed & 0xFFFFFFFF) << 96)
                | (zlib.crc32(site.encode()) << 64)
                | idx
            )
            rng = random.Random(key)
            if rng.random() >= rate:
                return None
            return kinds[rng.randrange(len(kinds))]

        return cls(fn)

    def lookup(self, site: str, index: int) -> Optional[str]:
        return self._fn(site, index)


class FaultInjector:
    """Counts dispatches per site and raises the scheduled fault, if any.

    ``poison_jobs`` makes a *job* (not a dispatch index) the fault: any
    seam fired with a poisoned uuid raises a permanent fault — the
    deterministic way to exercise batch bisection, because the fault
    follows the job through every requeue and split.
    """

    def __init__(
        self,
        schedule: Optional[FaultSchedule] = None,
        poison_jobs: Iterable[str] = (),
    ):
        self.schedule = schedule
        self.poison_jobs = frozenset(poison_jobs)
        self._lock = lockdep.named_lock("serving.injector")  # lockck: name(serving.injector)
        self._idx: dict = {}  # site -> next dispatch index
        self.injected: dict = {}  # (site, kind) -> count

    def fire(self, site: str, uuids: Iterable[str] = ()) -> None:
        with self._lock:
            idx = self._idx.get(site, 0)
            self._idx[site] = idx + 1
        if self.poison_jobs:
            for u in uuids:
                if u in self.poison_jobs:
                    self._count(site, "permanent")
                    raise SimulatedFault("permanent", site, idx)
        kind = self.schedule.lookup(site, idx) if self.schedule else None
        if kind is not None:
            self._count(site, kind)
            raise SimulatedFault(kind, site, idx)

    def _count(self, site: str, kind: str) -> None:
        with self._lock:
            key = f"{site}:{kind}"
            self.injected[key] = self.injected.get(key, 0) + 1

    def dispatches(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._idx.get(site, 0)
            return sum(self._idx.values())

    def metrics(self) -> dict:
        with self._lock:
            return {
                "dispatches": dict(self._idx),
                "injected": dict(self.injected),
            }


# -- the process-wide seam ----------------------------------------------------
#
# Production runs have no injector installed and pay one global read per
# dispatch.  Tests install one around an engine/cluster lifetime; the
# serving stack never threads injector objects through its layers.

_active: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
    global _active
    _active = injector


def active() -> Optional[FaultInjector]:
    return _active


@contextlib.contextmanager
def injected(injector: FaultInjector):
    """Scope an injector over a block (tests): always uninstalls."""
    install(injector)
    try:
        yield injector
    finally:
        install(None)


def fire(site: str, uuids: Iterable[str] = ()) -> None:
    """The seam: a no-op unless an injector is installed.  Call sites are
    the serving dispatch/fetch boundaries — engine launch/advance/fetch,
    resident attach/detach/advance, bulk rung dispatches, cluster sends."""
    inj = _active
    if inj is not None:
        inj.fire(site, uuids)
