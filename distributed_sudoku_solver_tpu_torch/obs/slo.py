"""Declarative service-level objectives with error-budget burn-rate alerts.

The serving tier can now answer "what is cluster p95?" (``obs/hist.py`` +
``obs/agg.py``); this module answers the question that follows it at a
millions-of-users tier: *are we inside our latency objective, and if not,
how fast are we burning the budget?*

**Grammar** (``--slo`` on the CLI)::

    --slo "solve_p95_ms<=250,error_rate<=0.01"

comma-separated objectives, each ``<metric><=<value>`` (``<`` also
accepted):

* ``<stream>_p<NN>_ms<=<T>`` — a latency objective: at least NN% of the
  stream's observations must complete within T ms.  The error *budget*
  is implied by the quantile: ``p95`` allows 5% slow, ``p99`` allows 1%.
  Streams are validated (an unknown stream is a boot-time ValueError,
  not a silently-empty objective):

  - ``solve`` — the client-visible HTTP wall, observed at every
    ``POST /solve`` terminal (``serving/http.py``) with 5xx statuses —
    including a 504 timeout, where the job merely gets cancelled —
    counted as errors.  This is the serving-tier SLI.
  - ``job`` — engine submit→resolve wall (``SolverEngine._finish_job``),
    which also covers non-HTTP work (cluster TASKs, library callers);
    errors are job-level failures.

* ``error_rate<=<R>`` — at most fraction R of the ``solve`` stream's
  observations may be errors; the budget is R itself.

**Burn rate** is the standard SRE form: over a sliding window
(``window_s``, sub-bucketed so old observations age out), ``burn =
(bad / total) / budget``.  ``burn == 1.0`` consumes the budget exactly
at the sustained allowable rate; crossing ``burn_threshold`` flips the
objective to *burning* — and the CROSSING (edge, not level) triggers the
PR-8 flight-recorder dump (``trace.active().dump("slo_burn", ...)`` —
the same atomic tmp+rename writer), so an SLO breach automatically
captures the span ring and a metrics snapshot as evidence.  Exactly one
dump per crossing: the objective must fall back under the threshold
before a new crossing can dump again.

**Hot-path contract** (the tracer's): the engine reaches the monitor
through the process-wide seam ``slo.active()`` — ``None`` unless
installed, so with no ``--slo`` the cost is one global read + one branch,
zero allocation.  All time comes from the injectable ``clock``, so the
simnet lane drives crossings deterministically with no sleeps.

Surfaces: ``GET /slo`` (state), the ``slo`` section of ``/metrics``
(counters: burns, dumps, per-objective burn rate/state), and Prometheus
via ``obs/prom.py`` (``objectives`` renders with an ``objective`` label).

Import discipline: stdlib + sibling ``obs`` modules only; never imports
the serving layers back (the metrics snapshot for dumps is an injected
``metrics_fn``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import re
import time
from collections import deque
from typing import Callable, Optional, Sequence

from distributed_sudoku_solver_tpu_torch.obs import lockdep, trace
from distributed_sudoku_solver_tpu_torch.obs.logctx import ctx_log

_LOG = logging.getLogger(__name__)

_LATENCY_PAT = re.compile(r"^([a-z][a-z0-9_]*)_p(\d{2})_ms(<=|<)(\d+(?:\.\d+)?)$")
_ERROR_PAT = re.compile(r"^error_rate(<=|<)(0?\.\d+|0|1(?:\.0+)?)$")

# The observation streams that actually exist (module docstring).  A
# typo'd stream must fail the boot, not quietly monitor nothing.
STREAMS = ("solve", "job")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One parsed objective.  ``kind`` is ``latency`` (threshold in ms,
    budget = 1 - NN/100) or ``error_rate`` (threshold IS the budget);
    ``stream`` names the observation feed the objective watches."""

    name: str  # the raw spec text, e.g. "solve_p95_ms<=250"
    kind: str  # 'latency' | 'error_rate'
    threshold: float  # ms for latency, rate for error_rate
    budget: float  # allowed bad fraction (must be > 0)
    stream: str = "solve"


def parse_slo(spec: str) -> tuple:
    """Parse the ``--slo`` grammar into objectives; loud ValueError on any
    malformed clause — including an unknown stream name (a
    silently-unfed objective is a lie on /slo)."""
    objectives = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        m = _LATENCY_PAT.match(clause)
        if m:
            stream, q, _op, val = m.groups()
            if stream not in STREAMS:
                raise ValueError(
                    f"bad SLO clause {clause!r}: unknown stream {stream!r} "
                    f"(supported: {', '.join(STREAMS)})"
                )
            budget = 1.0 - int(q) / 100.0
            if budget <= 0.0:
                raise ValueError(
                    f"bad SLO clause {clause!r}: p{q} leaves no error budget"
                )
            objectives.append(
                Objective(clause, "latency", float(val), budget, stream)
            )
            continue
        m = _ERROR_PAT.match(clause)
        if m:
            _op, rate = m.groups()
            r = float(rate)
            if not (0.0 < r < 1.0):
                raise ValueError(
                    f"bad SLO clause {clause!r}: rate must be in (0, 1)"
                )
            objectives.append(Objective(clause, "error_rate", r, r, "solve"))
            continue
        raise ValueError(
            f"bad SLO clause {clause!r}: expected "
            "'<stream>_p<NN>_ms<=<T>' or 'error_rate<=<R>'"
        )
    if not objectives:
        raise ValueError(f"empty SLO spec {spec!r}")
    return tuple(objectives)


class SloMonitor:
    """Windowed burn-rate monitor over per-request observations.

    ``observe(latency_s, error=...)`` is the single feed (the engine's
    job-resolution seam); every read (``state`` / ``metrics`` /
    ``burning``) prunes the window against the injected clock, so state
    decays even when traffic stops.  ``min_samples`` guards against a
    one-request window flapping the alert.  ``metrics_fn`` (injected at
    wiring time — this module never imports the engine) supplies the
    metrics snapshot embedded in burn dumps.
    """

    def __init__(
        self,
        objectives: Sequence[Objective],
        window_s: float = 60.0,
        sub_buckets: int = 6,
        burn_threshold: float = 1.0,
        min_samples: int = 10,
        clock: Callable[[], float] = time.monotonic,
        metrics_fn: Optional[Callable[[], dict]] = None,
    ):
        if not objectives:
            raise ValueError("SloMonitor needs at least one objective")
        self.objectives = tuple(objectives)
        self.window_s = float(window_s)
        self._n_sub = max(1, int(sub_buckets))
        self._sub_s = self.window_s / self._n_sub
        self.burn_threshold = float(burn_threshold)
        self.min_samples = max(1, int(min_samples))
        self._clock = clock
        self.metrics_fn = metrics_fn
        # Dump/observe can re-enter metrics() via metrics_fn -> engine
        # .metrics() -> slo.active().metrics(): reentrant by design.
        self._lock = lockdep.named_rlock("obs.slo")  # lockck: name(obs.slo)
        # Sub-buckets: [bucket_id, total, bad-per-objective list].
        self._buckets: deque = deque()
        self._burning = [False] * len(self.objectives)  # lockck: guard(_lock)
        self._breaches = [0] * len(self.objectives)  # lockck: guard(_lock)
        self.observed = 0  # lockck: guard(_lock)
        self.burns = 0  # lockck: guard(_lock) — threshold crossings (all objectives)
        self.dumps = 0  # lockck: guard(_lock) — flight-recorder dumps written on crossings

    # -- the observation feed ------------------------------------------------
    def observe(
        self, latency_s: float, error: bool = False, stream: str = "solve",
        shed: bool = False,
    ) -> None:
        """One observation on ``stream``: the HTTP layer feeds ``solve``
        (wall + status>=500 as error), the engine feeds ``job`` (wall +
        job failure).  Objectives only see their own stream's totals, so
        a 504 storm burns the ``solve`` objectives even though the
        underlying jobs merely got cancelled.

        ``shed=True`` marks a deliberate load-shedding response (a
        brownout 503/429, a saturation 429 — serving/brownout.py): it
        counts toward ``error_rate`` totals as a NON-error (an honest
        refusal must not burn the budget it protects) but is EXCLUDED
        from latency objectives entirely — a storm of ~1 ms refusals
        would otherwise dilute the latency window, collapse the burn
        signal, and flap the brownout ladder that produced them (the
        served requests' latency is the thing the objective watches)."""
        with self._lock:
            now = self._clock()
            bid = int(now // self._sub_s)
            self._prune_locked(bid)
            if not self._buckets or self._buckets[-1][0] != bid:
                n = len(self.objectives)
                self._buckets.append([bid, [0] * n, [0] * n])
            b = self._buckets[-1]
            lat_ms = latency_s * 1e3
            for i, o in enumerate(self.objectives):
                if o.stream != stream:
                    continue
                if o.kind == "error_rate":
                    bad = error and not shed
                elif shed:
                    continue  # refusals carry no service latency
                else:
                    bad = lat_ms > o.threshold
                b[1][i] += 1
                if bad:
                    b[2][i] += 1
            self.observed += 1
            self._evaluate_locked()

    def _prune_locked(self, cur_bid: int) -> None:
        min_bid = cur_bid - self._n_sub + 1
        while self._buckets and self._buckets[0][0] < min_bid:
            self._buckets.popleft()

    def _window_locked(self):
        """(total, bad) per objective over the live window."""
        n = len(self.objectives)
        total = [0] * n
        bad = [0] * n
        for _bid, t, b in self._buckets:
            for i in range(n):
                total[i] += t[i]
                bad[i] += b[i]
        return total, bad

    def _burn_rates_locked(self):
        total, bad = self._window_locked()
        rates = []
        for i, o in enumerate(self.objectives):
            if total[i] < self.min_samples:
                rates.append(0.0)
            else:
                rates.append((bad[i] / total[i]) / o.budget)
        return total, bad, rates

    def _evaluate_locked(self) -> None:
        total, bad, rates = self._burn_rates_locked()
        for i, o in enumerate(self.objectives):
            burning = rates[i] >= self.burn_threshold
            if burning and not self._burning[i]:
                # The crossing: log it (window identified), count it, and
                # capture the evidence exactly once for this excursion.
                self._burning[i] = True
                self._breaches[i] += 1
                self.burns += 1
                ctx_log(_LOG, "slo", o.name).warning(
                    "error-budget burn rate %.2f crossed threshold %.2f "
                    "(%d/%d bad over the last %.0fs window) — "
                    "flight-recorder dump triggered",
                    rates[i], self.burn_threshold, bad[i], total[i],
                    self.window_s,
                )
                self._dump_locked(o, rates[i])
            elif not burning and self._burning[i]:
                self._burning[i] = False
                ctx_log(_LOG, "slo", o.name).info(
                    "burn rate %.2f back under threshold %.2f "
                    "(window %.0fs) — re-armed",
                    rates[i], self.burn_threshold, self.window_s,
                )

    def _dump_locked(self, o: Objective, rate: float) -> None:
        """The breach captures its own evidence: the PR-8 flight recorder
        (atomic tmp+rename writer, never raises) dumps the span ring plus
        a metrics snapshot.  No recorder installed -> the breach is still
        counted/logged; there is just no ring to dump."""
        rec = trace.active()
        if rec is None:
            return
        metrics = None
        if self.metrics_fn is not None:
            try:
                metrics = self.metrics_fn()
            except Exception:  # noqa: BLE001 - evidence is best-effort
                metrics = None
        path = rec.dump(
            "slo_burn",
            metrics={
                "objective": o.name,
                "burn_rate": round(rate, 4),
                "metrics": metrics,
            },
        )
        if path is not None:
            self.dumps += 1

    # -- read surface --------------------------------------------------------
    def burn_snapshot(self) -> dict:
        """Per-objective current burn as a PUBLIC read API (ISSUE 15):
        before this, burn was only observable at crossing edges (the
        dump), which also made anything that wants to *act* on burn — the
        brownout controller (``serving/brownout.py``) — untestable without
        a traffic burst.  Each entry: current ``burn_rate``, ``headroom``
        (distance below the crossing threshold; negative = burning),
        ``burning``, and the windowed totals the rate was computed from.
        Prunes + quiet-evaluates like every read, so the snapshot decays
        when traffic stops.  Surfaced under ``GET /slo`` as ``burn``."""
        with self._lock:
            self._prune_locked(int(self._clock() // self._sub_s))
            self._evaluate_quiet_locked()
            total, bad, rates = self._burn_rates_locked()
            return {
                o.name: {
                    "stream": o.stream,
                    "burn_rate": round(rates[i], 4),
                    "headroom": round(self.burn_threshold - rates[i], 4),
                    "burning": self._burning[i],
                    "window_total": int(total[i]),
                    "window_bad": int(bad[i]),
                }
                for i, o in enumerate(self.objectives)
            }

    def burning(self) -> bool:
        with self._lock:
            self._prune_locked(int(self._clock() // self._sub_s))
            self._evaluate_quiet_locked()
            return any(self._burning)

    def _evaluate_quiet_locked(self) -> None:
        """Reads must see decayed state (an idle window stops burning)
        without re-running the crossing side effects out of observe order:
        only the burning -> not-burning direction is applied here."""
        _total, _bad, rates = self._burn_rates_locked()
        for i in range(len(self.objectives)):
            if self._burning[i] and rates[i] < self.burn_threshold:
                self._burning[i] = False
                ctx_log(_LOG, "slo", self.objectives[i].name).info(
                    "burn rate %.2f back under threshold %.2f — re-armed",
                    rates[i], self.burn_threshold,
                )

    def state(self) -> dict:
        return self.metrics()

    def metrics(self) -> dict:
        with self._lock:
            self._prune_locked(int(self._clock() // self._sub_s))
            self._evaluate_quiet_locked()
            total, bad, rates = self._burn_rates_locked()
            return {
                "window_s": self.window_s,
                "burn_threshold": self.burn_threshold,
                "min_samples": self.min_samples,
                "observed": int(self.observed),
                "burning": any(self._burning),
                "burns": int(self.burns),
                "dumps": int(self.dumps),
                "objectives": {
                    o.name: {
                        "stream": o.stream,
                        "budget": o.budget,
                        "threshold": o.threshold,
                        "burn_rate": round(rates[i], 4),
                        "burning": self._burning[i],
                        "breaches": int(self._breaches[i]),
                        "window_total": int(total[i]),
                        "window_bad": int(bad[i]),
                    }
                    for i, o in enumerate(self.objectives)
                },
            }


# -- the process-wide seam ----------------------------------------------------
#
# Mirrors obs/trace.py and serving/faults.py: production runs with no
# monitor installed and the engine's resolution seam pays one global read
# + one branch; --slo runs and tests install one around a lifetime.

_active: Optional[SloMonitor] = None


def install(monitor: Optional[SloMonitor]) -> None:
    global _active
    _active = monitor


def active() -> Optional[SloMonitor]:
    return _active


@contextlib.contextmanager
def installed(monitor: SloMonitor):
    """Scope a monitor over a block (tests): always uninstalls."""
    install(monitor)
    try:
        yield monitor
    finally:
        install(None)
