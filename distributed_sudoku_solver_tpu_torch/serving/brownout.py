"""SLO-burn-driven brownout: the observability plane finally *drives* admission.

Rounds 11-15 built a complete observability plane — stitched traces,
mergeable histograms, a declarative SLO monitor whose burn-rate crossings
dump the flight recorder — but a crossing only ever produced *evidence*:
under sustained overload the node observed its own death in perfect
detail while admitting every request that killed it.  This module closes
the loop (ROADMAP #6): a :class:`BrownoutController` turns the signals
the plane already exports into an **edge-triggered, hysteresis-guarded
stage ladder** that sheds load *by value*, not at random — possible only
because the front door (``serving/frontdoor``) already classifies every
request into cache / propagation / native / device tiers at submit time,
and the easy tiers are cheap to serve natively or to refuse (PAPERS.md,
"A Study Of Sudoku Solving Algorithms": backtracking handles easy
instances without device help).

**The stage ladder** (each stage strictly contains the previous one's
restrictions; cache hits and propagation verdicts serve at EVERY stage —
they cost microseconds and no device work):

====== =====================================================================
stage  admission policy
====== =====================================================================
0      healthy: every tier serves normally.
1      easy boards route **native-only**: the ``race_native`` device
       shadow fallback is suppressed, reclaiming the device lanes the
       easy tier was hedging with.
2      the easy tier is **shed** with ``503 + Retry-After`` at the front
       door; the hard tail still reaches the device.
3      only cache/propagation answers are admitted: anything that would
       cost a dispatch — easy or hard — is refused with ``429``.
====== =====================================================================

**Signals** (each normalized so 1.0 = "at the configured limit"; the
controller's pressure is the max over whatever signals are bound):

* ``burn`` — the max per-objective SLO burn rate
  (:meth:`obs.slo.SloMonitor.burn_snapshot`; burn 1.0 = consuming the
  error budget exactly at the sustained allowable rate);
* ``queue`` — resident admission-queue fill fraction
  (``serving/scheduler.py`` :meth:`ResidentFlight.admission_pressure`);
* ``wait`` — resident admission-wait p95 over ``wait_budget_s``;
* ``floor`` — ``rpc_floor_ms`` drift: the recent-window floor over the
  lifetime floor, normalized by ``floor_drift`` (a link whose sync floor
  quadrupled is a degrading tunnel, not a code change).

**Hysteresis** is two-sided and edge-triggered: pressure at or above
``enter`` climbs one stage per evaluation (never faster than ``hold_s``);
de-escalation requires pressure at or below ``exit`` *continuously* for
``quiet_s`` — a reading between the thresholds resets nothing upward but
also accrues no calm, so the ladder neither flaps nor decays under
sustained borderline load.  Every transition is counted exactly once,
``[brownout]`` ctx-logged, trace-evented, and flight-recorder dumped.

**Hot-path contract** (the tracer's): the serving path reaches the
controller through the process-wide seam ``brownout.active()`` — ``None``
unless installed, so the disabled path is one global read + one branch
(explode-microcheck pinned in tests/test_brownout.py).  All time comes
from the injectable ``clock``; signal callables are read OUTSIDE the
controller lock, and transition side effects (log/trace/dump) fire after
it is released, so the controller's lock is a leaf that never holds
another lock (deadck rank ``serving.brownout``).

**Scope**: shedding happens only for ``saturation='reject'`` submits —
the serving boundary, where a refusal becomes an honest HTTP answer.
Quiet-fallback callers (cluster TASK re-execution, library users, bulk
stragglers) are internal work the node already accepted; at shed stages
they degrade to the native-only policy instead of erroring.

Import discipline: stdlib + ``obs`` only (closed layer in
``analysis/manifest.py``) — the engine binds its signals through
:func:`engine_signals` duck-typed closures, never an import back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

from distributed_sudoku_solver_tpu_torch.obs import lockdep, slo, trace
from distributed_sudoku_solver_tpu_torch.obs.logctx import ctx_log

_LOG = logging.getLogger(__name__)

#: Admission verdicts from :meth:`BrownoutController.gate`.
SERVE = "serve"
NATIVE_ONLY = "native_only"
SHED = "shed"

#: The ladder's stage count (0..MAX_STAGE inclusive).
MAX_STAGE = 3

#: Shed tiers (the ``shed_tier`` field of every shed response).
TIERS = ("easy", "hard")


class BrownoutShed(RuntimeError):
    """A brownout stage refused this request at the front door.

    The HTTP layer turns it into the machine-readable shed response
    ``{stage, retry_after_s, shed_tier}`` — ``503`` at stage 2 (the easy
    tier is browned out, retry later), ``429`` at stage 3 (nothing that
    costs a dispatch is admitted).  Shed responses are recorded into the
    ``solve`` SLO stream as NON-errors: shedding exists to protect the
    error-rate objective, so it must not burn it.
    """

    def __init__(self, stage: int, retry_after_s: float, shed_tier: str,
                 uuid: Optional[str] = None):
        self.stage = int(stage)
        self.retry_after_s = float(retry_after_s)
        self.shed_tier = shed_tier
        self.status = 503 if self.stage == 2 else 429
        self.uuid = uuid
        super().__init__(
            f"browning out (stage {self.stage}): {shed_tier}-tier requests "
            f"are shed; retry after {self.retry_after_s:.1f}s"
        )


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Knobs for the stage ladder (CLI: ``--brownout-enter`` /
    ``--brownout-exit``; the controller itself is on by default whenever
    ``--slo`` is set, ``--no-brownout`` disables it)."""

    #: Pressure at or above which the ladder climbs one stage.
    enter: float = 1.0
    #: Pressure at or below which calm accrues toward de-escalation.
    #: Must be strictly below ``enter`` (the hysteresis band).
    exit: float = 0.5
    #: Continuous calm (pressure <= exit) before stepping DOWN one stage.
    quiet_s: float = 15.0
    #: Minimum dwell between consecutive UPWARD transitions, so one
    #: pressure spike cannot leap 0 -> 3 in a single burst of reads.
    hold_s: float = 1.0
    #: Signal re-evaluation is rate-limited to once per this interval
    #: (every ``stage()`` read past the interval re-evaluates, so the
    #: ladder also recovers on /metrics reads when traffic stops).
    eval_interval_s: float = 0.25
    #: Admission-wait p95 that counts as pressure 1.0 on the ``wait``
    #: signal.
    wait_budget_s: float = 1.0
    #: ``rpc_floor_ms`` recent/lifetime ratio that counts as pressure 1.0
    #: on the ``floor`` signal (4.0 = the sync floor quadrupled).  The
    #: signal is normalized over the DRIFT, not the raw ratio — an
    #: undrifted floor (recent == lifetime min) reads 0.0, so a healthy
    #: node carries no structural floor pressure whatever the
    #: enter/exit thresholds are set to.  Must be > 1.
    floor_drift: float = 4.0
    #: Retry-After hint on shed responses; 0 derives it from ``quiet_s``
    #: (the soonest the ladder could possibly step down).
    retry_after_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.exit < self.enter:
            raise ValueError(
                f"brownout exit threshold ({self.exit}) must be strictly "
                f"below enter ({self.enter}) — the hysteresis band"
            )
        if not self.floor_drift > 1.0:
            raise ValueError(
                f"floor_drift must be > 1 (got {self.floor_drift}): it is "
                "the recent/lifetime floor ratio that maps to pressure 1.0"
            )


class BrownoutController:
    """The stage ladder: signals in, admission verdicts out.

    ``signals`` maps signal names to zero-arg callables returning a
    normalized pressure (or ``None`` when the signal has no data yet);
    they are read with NO controller lock held — injected callables may
    acquire arbitrary observability locks (``engine_signals``).
    ``metrics_fn`` (optional, injected at wiring time) supplies the
    metrics snapshot embedded in transition dumps, exactly the SLO
    monitor's pattern.
    """

    SERVE, NATIVE_ONLY, SHED = SERVE, NATIVE_ONLY, SHED

    def __init__(
        self,
        config: Optional[BrownoutConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        signals: Optional[Dict[str, Callable[[], Optional[float]]]] = None,
        metrics_fn: Optional[Callable[[], dict]] = None,
    ):
        self.config = config or BrownoutConfig()
        self._clock = clock
        self._signals: Dict[str, Callable[[], Optional[float]]] = dict(
            signals or {}
        )
        self.metrics_fn = metrics_fn
        self._lock = lockdep.named_lock("serving.brownout")  # lockck: name(serving.brownout)
        now = clock()
        self._stage = 0  # lockck: guard(_lock)
        self._stage_since = now  # lockck: guard(_lock)
        self._last_eval: Optional[float] = None  # lockck: guard(_lock)
        self._last_up = now - self.config.hold_s  # lockck: guard(_lock)
        self._calm_since: Optional[float] = None  # lockck: guard(_lock)
        self._pressure: Dict[str, float] = {}  # lockck: guard(_lock) — last evaluated per-signal readings
        self.transitions = 0  # lockck: guard(_lock) — every stage change, exactly once
        self.escalations = 0  # lockck: guard(_lock)
        self.deescalations = 0  # lockck: guard(_lock)
        self.stage_entered = [0] * (MAX_STAGE + 1)  # lockck: guard(_lock)
        self._residency = [0.0] * (MAX_STAGE + 1)  # lockck: guard(_lock)
        self.shed_counts = {t: 0 for t in TIERS}  # lockck: guard(_lock)
        self.shed_by_stage = [0] * (MAX_STAGE + 1)  # lockck: guard(_lock)

    # -- signal wiring -------------------------------------------------------
    def set_signals(
        self, signals: Dict[str, Callable[[], Optional[float]]]
    ) -> None:
        """Replace the signal set (wiring time, before install)."""
        self._signals = dict(signals)

    # -- the admission surface ----------------------------------------------
    def stage(self) -> int:
        """Current stage; re-evaluates the signals at most once per
        ``eval_interval_s`` (the front door calls this per eligible
        submit, so under traffic the ladder tracks pressure closely, and
        /metrics reads keep it decaying when traffic stops)."""
        now = self._clock()
        with self._lock:
            due = (
                self._last_eval is None
                or now - self._last_eval >= self.config.eval_interval_s
            )
            if due:
                self._last_eval = now
        if due:
            return self.evaluate()
        with self._lock:
            return self._stage

    def gate(self, tier: str) -> tuple:
        """Admission verdict for a probed-open board of ``tier`` ('easy'
        or 'hard'): ``(SERVE | NATIVE_ONLY | SHED, stage)``.  Shedding
        callers raise :class:`BrownoutShed`; quiet callers downgrade a
        SHED verdict to the native-only policy themselves (module note).
        """
        s = self.stage()
        if tier == "easy":
            if s >= 2:
                return SHED, s
            if s == 1:
                return NATIVE_ONLY, s
        elif s >= 3:
            return SHED, s
        return SERVE, s

    def record_shed(self, tier: str, stage: int) -> None:
        """Count one shed response (called by whoever refused the
        request — the front door in production, a replay node's model)."""
        with self._lock:
            if tier in self.shed_counts:
                self.shed_counts[tier] += 1
            self.shed_by_stage[max(0, min(MAX_STAGE, int(stage)))] += 1

    def retry_after_s(self) -> float:
        """Retry-After for shed responses: configured, or the soonest a
        quiet window could walk the ladder down one stage."""
        if self.config.retry_after_s > 0:
            return self.config.retry_after_s
        return max(1.0, self.config.quiet_s)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self) -> int:
        """Read every signal, apply the hysteresis ladder, fire the
        transition side effects; returns the (possibly new) stage.

        Signals are read and side effects fired with the lock RELEASED:
        the lock guards only the transition decision and counters, so
        ``serving.brownout`` stays a leaf in the deadck hierarchy no
        matter what the injected callables touch.
        """
        readings: Dict[str, float] = {}
        for name, fn in self._signals.items():
            try:
                v = fn()
            except Exception:  # noqa: BLE001 - a broken signal is silence, not an outage
                v = None
            if v is not None:
                readings[name] = float(v)
        pressure = max(readings.values(), default=0.0)
        now = self._clock()
        cfg = self.config
        event = None
        with self._lock:
            self._pressure = readings
            old = self._stage
            if pressure >= cfg.enter:
                self._calm_since = None
                if old < MAX_STAGE and now - self._last_up >= cfg.hold_s:
                    self._transition_locked(old + 1, now)
                    self._last_up = now
                    event = (old, old + 1, pressure, dict(readings))
            elif pressure <= cfg.exit:
                if self._calm_since is None:
                    self._calm_since = now
                elif old > 0 and now - self._calm_since >= cfg.quiet_s:
                    self._transition_locked(old - 1, now)
                    # The next step down needs its own full quiet window.
                    self._calm_since = now
                    event = (old, old - 1, pressure, dict(readings))
            else:
                # Inside the hysteresis band: no climb, no calm accrual.
                self._calm_since = None
            stage = self._stage
        if event is not None:
            self._announce(*event)
        return stage

    def _transition_locked(self, new: int, now: float) -> None:
        self._residency[self._stage] += now - self._stage_since
        self._stage = new
        self._stage_since = now
        self.transitions += 1
        self.stage_entered[new] += 1

    def _announce(self, old: int, new: int, pressure: float,
                  readings: Dict[str, float]) -> None:
        """Transition side effects, fired OUTSIDE the lock: the
        ``[brownout]`` log line, the trace event, and the flight-recorder
        dump (evidence of what the node looked like when admission
        changed)."""
        up = new > old
        with self._lock:
            if up:
                self.escalations += 1
            else:
                self.deescalations += 1
        log = ctx_log(_LOG, "brownout", f"{old}->{new}")
        if up:
            log.warning(
                "pressure %.2f >= enter %.2f: escalating to stage %d (%s)",
                pressure, self.config.enter, new,
                ", ".join(f"{k}={v:.2f}" for k, v in sorted(readings.items()))
                or "no signals",
            )
        else:
            log.info(
                "pressure %.2f quiet for %.0fs: de-escalating to stage %d",
                pressure, self.config.quiet_s, new,
            )
        rec = trace.active()
        if rec is None:
            return
        rec.event(
            None, "brownout", "brownout.stage",
            attrs={"from": old, "to": new},
            pressure=round(pressure, 4),
        )
        metrics = None
        if self.metrics_fn is not None:
            try:
                metrics = self.metrics_fn()
            except Exception:  # noqa: BLE001 - evidence is best-effort
                metrics = None
        rec.dump(
            "brownout",
            metrics={
                "from": old,
                "to": new,
                "pressure": round(pressure, 4),
                "signals": {k: round(v, 4) for k, v in readings.items()},
                "metrics": metrics,
            },
        )

    # -- read surface --------------------------------------------------------
    def metrics(self) -> dict:
        """The ``brownout`` section of ``/metrics`` (prom renders ``shed``
        as a ``tier``-labeled table; residency/entered label by index)."""
        stage = self.stage()  # an idle ladder must decay on reads
        now = self._clock()
        with self._lock:
            residency = list(self._residency)
            residency[self._stage] += now - self._stage_since
            return {
                "stage": stage,
                "enter": self.config.enter,
                "exit": self.config.exit,
                "quiet_s": self.config.quiet_s,
                "transitions": int(self.transitions),
                "escalations": int(self.escalations),
                "deescalations": int(self.deescalations),
                "stage_entered": [int(n) for n in self.stage_entered],
                "stage_residency_s": [round(r, 3) for r in residency],
                "shed_total": int(sum(self.shed_counts.values())),
                "shed": {t: int(n) for t, n in self.shed_counts.items()},
                "shed_by_stage": [int(n) for n in self.shed_by_stage],
                "pressure": {
                    k: round(v, 4) for k, v in sorted(self._pressure.items())
                },
            }


def max_burn(mon) -> Optional[float]:
    """The ONE burn-pressure formula: the max per-objective burn rate
    from a monitor's :meth:`~obs.slo.SloMonitor.burn_snapshot` (None =
    no objectives).  Shared by :func:`engine_signals` and the replay
    harness's virtual nodes (``benchmarks/replay.py``) so the replayed
    ladder can never drift onto a different signal than production."""
    snap = mon.burn_snapshot()
    rates = [o["burn_rate"] for o in snap.values()]
    return max(rates) if rates else None


def engine_signals(engine, config: Optional[BrownoutConfig] = None) -> dict:
    """The production signal set over one engine, as duck-typed closures
    (this module never imports the serving layers back): SLO burn,
    resident queue fill, admission-wait p95, and rpc-floor drift."""
    cfg = config or BrownoutConfig()

    # Names kept globally unique on purpose: deadck's call-graph resolver
    # is name-based, and a nested function named `wait` would alias
    # threading.Condition.wait and poison the static lock graph with
    # false edges (the frontdoor cache's get/put lesson, round 17).
    def _burn_signal() -> Optional[float]:
        mon = slo.active()
        if mon is None:
            return None
        return max_burn(mon)

    def _queue_signal() -> Optional[float]:
        best = None
        for rf in engine._resident_flights():
            frac, _wait_p95 = rf.admission_pressure()
            best = frac if best is None else max(best, frac)
        return best

    def _wait_signal() -> Optional[float]:
        best = None
        for rf in engine._resident_flights():
            _frac, wait_p95 = rf.admission_pressure()
            best = wait_p95 if best is None else max(best, wait_p95)
        if best is None:
            return None
        return best / cfg.wait_budget_s

    def _floor_signal() -> Optional[float]:
        d = engine.rpc_floor.to_dict()
        if not d or not d.get("min") or d["min"] <= 0:
            return None
        # Normalized over the DRIFT: recent == lifetime min -> 0.0 (a
        # healthy link exerts no pressure, whatever the thresholds),
        # recent == floor_drift x min -> 1.0.  A raw-ratio form had a
        # structural 1/drift baseline that made any --brownout-exit at
        # or below it an un-recoverable shed state (review finding).
        ratio = d.get("recent", d["min"]) / d["min"]
        return max(0.0, ratio - 1.0) / (cfg.floor_drift - 1.0)

    return {
        "burn": _burn_signal,
        "queue": _queue_signal,
        "wait": _wait_signal,
        "floor": _floor_signal,
    }


def bind_engine(ctrl: BrownoutController, engine) -> None:
    """Wire a controller to one engine: production signals + the metrics
    snapshot for transition dumps (cli.py calls this post-boot)."""
    ctrl.set_signals(engine_signals(engine, ctrl.config))
    ctrl.metrics_fn = engine.metrics


# -- the process-wide seam ----------------------------------------------------
#
# Mirrors obs/slo.py / obs/trace.py / serving/faults.py: production with
# no controller installed pays one global read + one branch at the front
# door's routing decision and at engine.metrics.

_active: Optional[BrownoutController] = None


def install(controller: Optional[BrownoutController]) -> None:
    global _active
    _active = controller


def active() -> Optional[BrownoutController]:
    return _active


@contextlib.contextmanager
def installed(controller: BrownoutController):
    """Scope a controller over a block (tests): always uninstalls."""
    install(controller)
    try:
        yield controller
    finally:
        install(None)
