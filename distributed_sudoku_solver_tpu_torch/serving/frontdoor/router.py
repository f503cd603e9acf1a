"""Difficulty probe + route selection: the front door's decision tier.

``probe_propagate`` is one bounded propagation-only pass — eliminations
plus hidden singles to a fixpoint, host-side numpy, zero device work.  It
is a *sound under-approximation* of the device kernels' propagation: a
board it completes is solved by forced deductions alone (the grid is THE
unique solution), and a contradiction it derives is a proof of
unsatisfiability — both verdicts are final whatever the engine's
configured rule tier.  Boards it leaves open are scored by remaining
branching slack (sum of ``candidates - 1`` over undecided cells), the
quantity DFS cost actually tracks.

:class:`FrontDoor` wires the three tiers onto the engine's submit seam:
canonical-cache lookup, then the probe, then the route — easy boards to
the native C++ DFS via :func:`serving.portfolio.race_native` (first
verdict wins; a delayed device fallback covers a misjudged board), the
hard tail to resident/static flights untouched.  Device-routed jobs
carry a resolution hook that fills the cache when their verdict lands,
so a hard board is paid for once per orbit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from collections import OrderedDict
from typing import Optional

import numpy as np

from distributed_sudoku_solver_tpu_torch.models.geometry import Geometry
from distributed_sudoku_solver_tpu_torch.obs import lockdep, ordertrace, slo, trace
from distributed_sudoku_solver_tpu_torch.serving import brownout
from distributed_sudoku_solver_tpu_torch.serving.frontdoor import cache as cache_mod
from distributed_sudoku_solver_tpu_torch.serving.frontdoor import canonical as canon_mod

_LOG = logging.getLogger(__name__)

#: Device-routed jobs awaiting a verdict for cache fill: bound the map so
#: abandoned uuids (errors, overflows) can never grow it without limit.
_PENDING_BOUND = 4096


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    status: str  # 'solved' | 'unsat' | 'open'
    solution: Optional[np.ndarray]  # int32[n, n] when solved
    empties: int  # undecided cells after propagation
    score: int  # sum of (candidates - 1) over undecided cells
    sweeps: int  # propagation sweeps consumed


def _popcounts(m: np.ndarray, digits: np.ndarray) -> np.ndarray:
    return ((m[..., None] >> digits) & 1).sum(-1)


def probe_propagate(grid, geom: Geometry, max_sweeps: int = 64) -> ProbeResult:
    """Eliminations + hidden singles to a fixpoint (bounded by
    ``max_sweeps``).  See the module docstring for the soundness
    contract; out-of-range cell values make the board 'open' (the device
    path keeps whatever behavior it has for malformed values)."""
    n = geom.n
    g = np.asarray(grid, dtype=np.int64)
    if g.shape != (n, n) or g.min() < 0 or g.max() > n:
        return ProbeResult("open", None, n * n, n * n * (n - 1), 0)
    full = (1 << n) - 1
    m = np.full((n, n), full, dtype=np.int64)
    nz = g > 0
    m[nz] = np.int64(1) << (g[nz] - 1)
    digits = np.arange(n, dtype=np.int64)
    weights = np.int64(1) << digits
    vb, hb, bh, bw = geom.n_vboxes, geom.n_hboxes, geom.box_h, geom.box_w

    def duplicate_assigned(mm: np.ndarray) -> bool:
        pc = _popcounts(mm, digits)
        singles = np.where(pc == 1, mm, 0)
        sb = (singles[..., None] >> digits) & 1
        if (sb.sum(axis=1) > 1).any() or (sb.sum(axis=0) > 1).any():
            return True
        return bool((sb.reshape(vb, bh, hb, bw, n).sum(axis=(1, 3)) > 1).any())

    sweeps = 0
    for sweeps in range(1, max_sweeps + 1):
        prev = m
        if duplicate_assigned(m):
            return ProbeResult("unsat", None, 0, 0, sweeps)
        pc = _popcounts(m, digits)
        singles = np.where(pc == 1, m, 0)
        row_or = np.bitwise_or.reduce(singles, axis=1)
        col_or = np.bitwise_or.reduce(singles, axis=0)
        box_or = np.bitwise_or.reduce(
            np.bitwise_or.reduce(singles.reshape(vb, bh, hb, bw), axis=3), axis=1
        )
        box_exp = np.repeat(np.repeat(box_or, bh, axis=0), bw, axis=1)
        elim = (row_or[:, None] | col_or[None, :] | box_exp) & ~singles
        m = m & ~elim
        if (m == 0).any():
            return ProbeResult("unsat", None, 0, 0, sweeps)
        # Hidden singles: a digit confined to one cell of a unit pins that
        # cell.  Two distinct pinned digits meeting in one cell is a proof
        # of contradiction (the cell cannot be both).
        bits = (m[..., None] >> digits) & 1
        row_u = bits.sum(axis=1) == 1  # (n, d)
        col_u = bits.sum(axis=0) == 1
        box_u = bits.reshape(vb, bh, hb, bw, n).sum(axis=(1, 3)) == 1
        box_u_exp = np.repeat(np.repeat(box_u, bh, axis=0), bw, axis=1)
        uniq = row_u[:, None, :] | col_u[None, :, :] | box_u_exp
        hid = m & (uniq * weights).sum(-1)
        if (_popcounts(hid, digits) > 1).any():
            return ProbeResult("unsat", None, 0, 0, sweeps)
        m = np.where(hid != 0, hid, m)
        if (m == 0).any():  # pragma: no cover - hid is a subset of m
            return ProbeResult("unsat", None, 0, 0, sweeps)
        if np.array_equal(m, prev):
            break
    pc = _popcounts(m, digits)
    if (pc == 1).all():
        if duplicate_assigned(m):
            return ProbeResult("unsat", None, 0, 0, sweeps)
        sol = (((m[..., None] >> digits) & 1).argmax(-1) + 1).astype(np.int32)
        return ProbeResult("solved", sol, 0, 0, sweeps)
    open_cells = pc > 1
    return ProbeResult(
        "open",
        None,
        int(open_cells.sum()),
        int((pc[open_cells] - 1).sum()),
        sweeps,
    )


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Knobs for the routing layer (CLI: ``--cache-entries``; the whole
    layer is bypassed with ``--no-frontdoor``)."""

    cache_entries: int = 65536
    #: Boards whose post-propagation branching slack is at or below this
    #: route to the native DFS; above it, to resident/static flights.
    #: The default keeps genuinely hard published boards (AI Escargot
    #: scores in the hundreds) on the device path while the easy mass —
    #: a few undecided cells with 2-3 candidates — stays native.
    easy_score: int = 64
    probe_sweeps: int = 64
    #: Head start the native racer gets before the device fallback is
    #: submitted (serving/portfolio.race_native).
    native_head_start_s: float = 0.5
    canonical_max_states: int = canon_mod.MAX_STATES


class FrontDoor:
    """The routing layer, bound to one engine's submit seam."""

    def __init__(self, engine, config: Optional[FrontDoorConfig] = None):
        self.engine = engine
        self.config = config or FrontDoorConfig()
        self.cache = cache_mod.ResultCache(self.config.cache_entries)
        # Cluster-wide cache seam: an injected second level
        # behind the local LRU.  Duck-typed — ``lookup(digest, raw) ->
        # Optional[CacheEntry]`` and ``store(digest, entry)`` — so this
        # layer never imports cluster; ``cluster/node.py`` installs its
        # adapter at start().  None = single-node, zero behavior change.
        self.l2 = None
        self._lock = lockdep.named_lock("frontdoor.router")  # lockck: name(frontdoor.router)
        self.route_counts = {  # lockck: guard(_lock)
            "cache": 0, "propagation": 0, "native": 0, "device": 0,
        }
        self.probe_counts = {  # lockck: guard(_lock)
            "solved": 0, "unsat": 0, "easy": 0, "hard": 0,
        }
        self.uncacheable = 0  # lockck: guard(_lock) — boards with no canonical form
        self.cluster_hits = 0  # lockck: guard(_lock) — L1 misses answered by the L2 seam
        self.native_fallback_wins = 0  # lockck: guard(_lock) — device fallback beat the native racer
        self.answered = 0  # lockck: guard(_lock) — jobs resolved by the front door itself
        self.answered_solved = 0  # lockck: guard(_lock)
        self.answered_nodes = 0  # lockck: guard(_lock) — native racer nodes (stats parity)
        self._pending: "OrderedDict[str, tuple]" = OrderedDict()  # lockck: guard(_lock)
        # Probe availability ONCE, at construction: native.available()
        # may build the shared library (a bounded g++ run) and must never
        # do so on a request thread.
        try:
            from distributed_sudoku_solver_tpu_torch import native

            self.native_available = bool(native.available())
        except Exception:  # pragma: no cover - import/abi failure
            self.native_available = False

    # -- the submit seam -----------------------------------------------------
    def route(self, job, saturation: str = "fallback"):
        """Route one eligible job.  Returns ``(owned, token)``:
        ``owned=True`` means the front door resolved it (cache /
        propagation) or the native race will; ``owned=False`` means hard
        tail — the caller places the job on its device paths and, once
        placement SUCCEEDED, hands ``token`` to :meth:`commit_device`
        (which does the device-route bookkeeping; deferring it keeps a
        saturation 429 from inflating counters or parking a dead
        cache-fill entry).

        With a brownout controller installed (``serving/brownout.py``)
        the routing decision is also the SHEDDING point — the one place
        in the system where a request's cost tier is known before any of
        that cost is paid.  Cache hits and propagation verdicts serve at
        every stage; probed-open boards consult the stage ladder, and a
        shed verdict raises :class:`serving.brownout.BrownoutShed` for
        ``saturation='reject'`` submits (the HTTP boundary turns it into
        503/429 + Retry-After) while quiet-fallback callers — internal
        work the node already accepted — degrade to the native-only
        policy instead of erroring."""
        rec = trace.active()
        t0 = rec.now() if rec is not None else 0.0
        raw = self._raw_digest(job)
        try:
            cf = canon_mod.canonicalize(
                job.grid, job.geom, self.config.canonical_max_states
            )
        except ValueError:
            # Out-of-range cell values: not an orbit.  The seam stays
            # transparent — the board is uncacheable and the device path
            # keeps whatever semantics it has for malformed values.
            cf = None
        entry = None
        if cf is None:
            with self._lock:
                self.uncacheable += 1
        else:
            entry = self.cache.lookup_entry(cf.digest, raw)
            if entry is None and self.l2 is not None:
                # L1 miss -> ask the cluster cache (digest owner).  Any
                # wire trouble is just a miss.  A hit is promoted into
                # the local LRU (read-through) so the next job in this
                # orbit answers wire-free.
                entry = self.l2.lookup(cf.digest, raw)
                if entry is not None:
                    self.cache.store_entry(cf.digest, entry)
                    with self._lock:
                        self.cluster_hits += 1
        if rec is not None:
            rec.record(
                job.uuid, "cache.lookup", "frontdoor.cache", t0,
                node=self.engine.trace_node,
                hit=entry is not None, cacheable=cf is not None,
            )
        if entry is not None:
            self._resolve(
                job, "cache",
                solved=entry.verdict == cache_mod.SOLVED,
                solution=None if entry.solution is None
                else canon_mod.restore_solution(
                    entry.solution, cf.transform
                ).astype(np.int32),
                unsat=entry.verdict == cache_mod.UNSAT,
                nodes=0,
            )
            return True, None

        t1 = rec.now() if rec is not None else 0.0
        pr = probe_propagate(job.grid, job.geom, self.config.probe_sweeps)
        # Journaled with the route outcome by the ordering trace
        # (obs/ordertrace.py) — the offline threshold learner's features.
        job.probe_score = int(pr.score)
        job.probe_empties = int(pr.empties)
        if rec is not None:
            rec.record(
                job.uuid, "probe", "frontdoor.probe", t1,
                node=self.engine.trace_node,
                status=pr.status, score=pr.score, sweeps=pr.sweeps,
            )
        if pr.status == "solved":
            with self._lock:
                self.probe_counts["solved"] += 1
            self._resolve(job, "propagation", solved=True,
                          solution=pr.solution, nodes=0)
            self._fill_cache(cf, raw, job)
            return True, None
        if pr.status == "unsat":
            with self._lock:
                self.probe_counts["unsat"] += 1
            self._resolve(job, "propagation", solved=False, unsat=True, nodes=0)
            self._fill_cache(cf, raw, job)
            return True, None

        # Brownout gate (serving/brownout.py): the stage ladder decides
        # whether this tier is admitted at all, and whether the easy
        # tier's device shadow is suppressed.  Disabled path = one global
        # read + one branch (explode-microcheck pinned).
        easy_tier = pr.score <= self.config.easy_score
        ctrl = brownout.active()
        action, bo_stage = (
            ctrl.gate("easy" if easy_tier else "hard")
            if ctrl is not None
            else (brownout.SERVE, 0)
        )
        if action == brownout.SHED:
            if saturation == "reject":
                tier = "easy" if easy_tier else "hard"
                ctrl.record_shed(tier, bo_stage)
                if rec is not None:
                    rec.record(
                        job.uuid, "route", "frontdoor.route",
                        rec.now(), node=self.engine.trace_node,
                        route="shed", stage=bo_stage, tier=tier,
                        score=pr.score,
                    )
                raise brownout.BrownoutShed(
                    bo_stage, ctrl.retry_after_s(), tier, uuid=job.uuid
                )
            # Quiet callers degrade, never error: internal work the node
            # already accepted serves at the stage-1 policy.
            action = brownout.NATIVE_ONLY if easy_tier else brownout.SERVE
        easy = easy_tier and self.native_available
        t2 = rec.now() if rec is not None else 0.0
        if rec is not None:
            rec.record(
                job.uuid, "route", "frontdoor.route", t2,
                node=self.engine.trace_node,
                route="native" if easy else "device", score=pr.score,
            )
        if easy:
            with self._lock:
                self.probe_counts["easy"] += 1
                self.route_counts["native"] += 1
            from distributed_sudoku_solver_tpu_torch.serving.portfolio import race_native

            job.route = "native"
            race_native(
                self.engine, job,
                head_start_s=self.config.native_head_start_s,
                on_verdict=lambda j, cf=cf, raw=raw: self._native_verdict(
                    j, cf, raw
                ),
                # Stage >= 1: native-only — the device shadow's lanes go
                # back to the hard tail.
                device_fallback=action != brownout.NATIVE_ONLY,
            )
            return True, None
        job.route = "device"
        return False, (cf, raw)

    def commit_device(self, job, token) -> None:
        """Device-route bookkeeping, called by the engine AFTER the job
        landed on a flight path: counters bump and the cache-fill hook
        attaches only for jobs that will actually run (a rejected
        saturation submit commits nothing).  A job that resolved in the
        sub-millisecond window before this commit simply misses its
        cache fill — a bounded miss, never a wrong answer."""
        cf, raw = token
        with self._lock:
            self.probe_counts["hard"] += 1
            self.route_counts["device"] += 1
            if cf is not None:
                self._pending[job.uuid] = (cf, raw)
                while len(self._pending) > _PENDING_BOUND:
                    self._pending.popitem(last=False)
        if cf is not None:
            job.on_resolve = self._device_resolved

    # -- resolution paths ----------------------------------------------------
    def _resolve(self, job, route, solved, solution=None, unsat=False, nodes=0):
        """Resolve a job the front door answered itself (cache hit or
        propagation verdict) with the engine's usual accounting."""
        eng = self.engine
        job.route = route
        job.solved = bool(solved)
        job.unsat = bool(unsat)
        # The engine's verdict convention: unsat is derived from a
        # COMPLETE refutation of the search space, which downstream
        # consumers (cluster _Exec finalization) read off `exhausted` —
        # a propagation contradiction or cached negative entry is exactly
        # such a proof.  Without this, a cluster node finalizes a
        # front-door 422 as a verdictless 500 (found by live /verify).
        job.exhausted = bool(unsat)
        job.solution = solution
        job.nodes = int(nodes)
        wall = eng._clock() - job.submitted_at
        eng.latency.record(wall)
        eng.hist["latency_ms"].record(wall)
        eng.hist[f"frontdoor_{route}_ms"].record(wall)
        mon = slo.active()
        if mon is not None:
            mon.observe(wall, error=False, stream="job")
        with self._lock:
            if route in ("cache", "propagation"):  # native/device count at dispatch
                self.route_counts[route] += 1
            self.answered += 1
            if job.solved:
                self.answered_solved += 1
        rec = trace.active()
        if rec is not None:
            rec.event(
                job.uuid, "resolve", "frontdoor.resolve",
                node=eng.trace_node, route=route,
                solved=job.solved, unsat=job.unsat,
            )
        ot = ordertrace.active()
        if ot is not None:
            ot.route(
                job.uuid, job.probe_score, job.probe_empties, route,
                wall * 1000.0, job.solved, job.unsat, job.nodes,
            )
        # Front-door-owned verdicts never cross _finish_job, so the WAL
        # discharge (serving/journal.py) happens here.
        eng._journal_resolved(job)
        job.done.set()

    def _native_verdict(self, job, cf, raw) -> None:
        """race_native's resolution callback (runs on the winning
        entrant's thread, before the job's done-event is set, for EVERY
        resolution — verdicts, cancels, errors).  The race's device
        fallback is a *shadow* job (engine accounting skips it), so this
        is the ONE place the user's request is counted, whichever
        entrant won: ``job.route`` says which ('native' or 'device'), and
        the wall lands in that route's histogram."""
        eng = self.engine
        wall = eng._clock() - job.submitted_at
        route = job.route if job.route in ("native", "device") else "native"
        eng.hist[f"frontdoor_{route}_ms"].record(wall)
        eng.latency.record(wall)
        eng.hist["latency_ms"].record(wall)
        mon = slo.active()
        if mon is not None:
            mon.observe(wall, error=job.error is not None, stream="job")
        with self._lock:
            self.answered += 1
            if job.solved:
                self.answered_solved += 1
            self.answered_nodes += int(job.nodes)
            if route == "device":
                self.native_fallback_wins += 1
        ot = ordertrace.active()
        if ot is not None:
            ot.route(
                job.uuid, job.probe_score, job.probe_empties, route,
                wall * 1000.0, job.solved, job.unsat, job.nodes,
            )
        self._fill_cache(cf, raw, job)
        # The race's primary job resolves here (its device fallback is a
        # shadow _finish_job skips): discharge the WAL entry.
        eng._journal_resolved(job)

    def _device_resolved(self, job) -> None:
        """Job.on_resolve hook: runs inside engine._finish_job (device
        loop) for device-routed jobs that carried a canonical form."""
        with self._lock:
            pending = self._pending.pop(job.uuid, None)
        self.engine.hist["frontdoor_device_ms"].record(
            self.engine._clock() - job.submitted_at
        )
        if pending is not None:
            cf, raw = pending
            self._fill_cache(cf, raw, job)

    def _fill_cache(self, cf, raw: str, job) -> None:
        """Insert a finished job's verdict under its canonical digest.
        Only real verdicts are cacheable: solved with a solution, or a
        completed unsat proof — cancelled/errored/overflowed jobs leave
        no entry."""
        if cf is None:
            return
        if job.error is not None or job.cancelled:
            return
        if job.solved and job.solution is not None:
            entry = cache_mod.CacheEntry(
                verdict=cache_mod.SOLVED,
                solution=canon_mod.apply_transform(
                    np.asarray(job.solution), cf.transform
                ).astype(np.int8),
                nodes=int(job.nodes),
                raw_digest=raw,
                route=job.route or "device",
            )
        elif job.unsat:
            entry = cache_mod.CacheEntry(
                verdict=cache_mod.UNSAT, solution=None, nodes=int(job.nodes),
                raw_digest=raw, route=job.route or "device",
            )
        else:
            return
        self.cache.store_entry(cf.digest, entry)
        if self.l2 is not None:
            # Async on the adapter's side for remote owners: the filling
            # thread is often the device loop, which must never wait on
            # the wire.
            self.l2.store(cf.digest, entry)

    # -- plumbing ------------------------------------------------------------
    @staticmethod
    def _raw_digest(job) -> str:
        h = hashlib.sha256()
        h.update(f"{job.geom.box_h}x{job.geom.box_w}:".encode())
        h.update(np.ascontiguousarray(job.grid, dtype=np.int32).tobytes())
        return h.hexdigest()

    def merge_stats(self, stats: dict) -> dict:
        """Fold front-door-answered jobs into the engine's stats triple
        (the /stats and /metrics base counters keep meaning 'jobs this
        node answered', whichever tier answered them)."""
        with self._lock:
            stats["jobs_done"] += self.answered
            stats["solved"] += self.answered_solved
            stats["validations"] += self.answered_nodes
        return stats

    def metrics(self) -> dict:
        with self._lock:
            out = {
                "routes": dict(self.route_counts),
                "probe": dict(self.probe_counts),
                "uncacheable": int(self.uncacheable),
                "cluster_hits": int(self.cluster_hits),
                "native_available": bool(self.native_available),
                "native_fallback_wins": int(self.native_fallback_wins),
                "pending_fills": len(self._pending),
            }
        out["cache"] = self.cache.metrics()
        return out
