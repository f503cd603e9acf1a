"""Per-job flight-recorder tracing: spans from HTTP accept to device chunk.

A :class:`TraceRecorder` is a process-wide, clock-injectable span recorder
over a bounded ring — a *flight recorder*: always cheap enough to leave
on, always holding the recent past when something goes wrong.  Spans are
plain dicts (JSON-safe by construction) recording one job's lifecycle:

* ``http.solve`` — HTTP accept to response;
* ``admission`` — submit to flight launch / resident attach (the queue
  wait), with the route taken (``static`` / ``resident``);
* ``chunk.dispatch`` / ``chunk.sync`` and the resident twins — each device
  chunk's async enqueue vs its ONE status sync, sited on the fault plane's
  existing vocabulary (``engine.advance``, ``fetch.status``, ...), so the
  trace and fault planes name the world identically;
* recovery events — ``recovery.requeue`` / ``recovery.downgrade`` /
  ``recovery.bisect`` / ``recovery.rebuild`` / ``recovery.rehome`` /
  ``breaker`` transitions / ``fault.permanent``;
* ``resolve`` — the job's terminal verdict;
* ``send.<METHOD>`` / ``recv.<METHOD>`` — cluster wire egress/ingress for
  uuid-bearing frames (TASK / SUBTASK / SOLUTION / PART_RESULT / ...).

**The contract with the serving hot loops** (the same one the fault plane
honors): recording is reached through the process-wide seam
``trace.active()`` — ``None`` in production unless installed — so the
disabled path is one attribute read and one branch, with zero allocation
(no uuid tuples, no span dicts, no clock reads); and span payloads are
built exclusively from values the loop already holds on the host, so
tracing adds **zero host syncs** (the round-8 one-sync-per-chunk guard in
``tests/test_status_pipeline.py`` runs with tracing enabled to enforce
it).

**Cluster stitching**: trace context (the root job uuid) rides
TASK / SUBTASK / SOLUTION / PART_RESULT frames as a ``"trace"`` field;
receivers :meth:`TraceRecorder.link` derived uuids (shed part uuids) to
the root trace, and result-bearing replies ship the executor's spans back
(bounded) for the origin to :meth:`TraceRecorder.ingest` — so a
distributed solve reconstructs as ONE trace on the origin, each span
tagged with the node that recorded it.  Ingest dedupes by span id, which
makes the ship-back a no-op when nodes share a recorder (the simnet
lane's single process).

Timestamps come from the injectable ``clock`` only, so the simnet lane
asserts multi-node stitching on its virtual clock with no sleeps.

**Call-scoped recordings** (:func:`recording`): a call that wants its
own spans under one trace id (``ops/bulk.solve_bulk``: one id per pass)
opens a :class:`Recording` over its body.  The code below it reaches the
recording through :func:`current`, a context variable, so a serving flight
on another thread never sees it.  Each span goes to the installed
recorder, is counted by name in the recording's ``counts``, and, where
the caller asks to keep them, is kept, unbounded, in its ``spans``.

Import discipline: stdlib only (like ``serving/faults.py``).  Everything
imports this module; it imports nothing of the system back.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import logging
import math
import numbers
import os
from distributed_sudoku_solver_tpu_torch.obs import lockdep
import time
import types
import uuid
from typing import Callable, Iterable, Optional

_LOG = logging.getLogger(__name__)

# Bound on spans shipped back per result-bearing frame (SOLUTION /
# PART_RESULT): ~200 B/span keeps the frame far under wire.MAX_FRAME.
EXPORT_SPAN_CAP = 256
# Bound on spans accepted per ingest call (a forged frame must not be able
# to flush the whole ring with garbage).
INGEST_SPAN_CAP = 1024


def _json_safe(v):
    """Coerce an attr value to a JSON-native type (numpy scalars arrive
    from unpacked status words; anything else degrades to ``str``)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return str(v)


class TraceRecorder:
    """Bounded-ring span recorder; every method is thread-safe.

    ``clock`` is the single time source for every span (inject the simnet
    virtual clock for deterministic tests).  The default is **wall time**
    (``time.time``), not monotonic: spans stitched across cluster nodes
    come from different processes, and per-process monotonic origins are
    arbitrary — wall clocks agree to NTP accuracy, which is what makes a
    multi-node Perfetto timeline readable.  (perfetto() sorts events, so
    a rare NTP step cannot produce a non-monotone export.)  ``node``
    labels spans recorded without an explicit node (cluster nodes pass
    their address); ``dump_dir`` enables the automatic flight-recorder
    dump — permanent faults and breaker-open transitions write the last
    ``dump_spans`` spans plus a metrics snapshot to a JSON logfile there.
    """

    def __init__(
        self,
        ring: int = 4096,
        clock: Callable[[], float] = time.time,
        node: str = "local",
        dump_dir: Optional[str] = None,
        dump_spans: int = 512,
    ):
        self._clock = clock
        self.node = node
        self.dump_dir = dump_dir
        self.dump_spans = max(1, dump_spans)
        self._lock = lockdep.named_lock("obs.trace")  # lockck: name(obs.trace)
        self._ring: collections.deque = collections.deque(maxlen=max(16, ring))
        # child uuid -> root trace id (shed parts under their job), bounded
        # like the engine's stale-cancel ledger.
        self._links: collections.OrderedDict = collections.OrderedDict()
        # span ids already recorded/ingested: makes ingest idempotent under
        # at-least-once delivery AND a no-op for spans this recorder itself
        # produced (nodes sharing one recorder in the simnet lane).
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._seq = 0  # lockck: guard(_lock)
        self.dumps = 0  # lockck: guard(_lock)
        self.remote_spans_ingested = 0  # lockck: guard(_lock)

    # -- time ----------------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    # -- recording -----------------------------------------------------------
    def record(
        self,
        trace: Optional[str],
        name: str,
        site: str,
        t0: float,
        t1: Optional[float] = None,
        node: Optional[str] = None,
        uuids: Iterable[str] = (),
        attrs: Optional[dict] = None,
        **kw,
    ) -> dict:
        """Record one complete span (``t1`` defaults to now).  ``trace`` is
        the primary job uuid (None for flight-level spans, which attribute
        to every uuid in ``uuids`` instead); extra keyword args and
        ``attrs`` merge into the span's attrs dict."""
        if t1 is None:
            t1 = self.now()
        a = {k: _json_safe(v) for k, v in kw.items()}
        if attrs:
            a.update((k, _json_safe(v)) for k, v in attrs.items())
        with self._lock:
            self._seq += 1
            span = {
                "id": f"{node or self.node}/{self._seq}",
                "trace": trace,
                "name": name,
                "site": site,
                "t0": float(t0),
                "t1": float(t1),
                "node": node or self.node,
                "uuids": [str(u) for u in uuids],
                "attrs": a,
            }
            self._ring.append(span)
            self._remember_locked(span["id"])
        return span

    def event(
        self,
        trace: Optional[str],
        name: str,
        site: str,
        node: Optional[str] = None,
        uuids: Iterable[str] = (),
        attrs: Optional[dict] = None,
        **kw,
    ) -> dict:
        """An instant (zero-duration) span at the current clock reading."""
        t = self.now()
        return self.record(
            trace, name, site, t, t1=t, node=node, uuids=uuids, attrs=attrs, **kw
        )

    def _remember_locked(self, span_id: str) -> None:
        self._seen[span_id] = None
        while len(self._seen) > 2 * self._ring.maxlen:
            self._seen.popitem(last=False)

    # -- trace-context propagation (cluster wire) ----------------------------
    def link(self, child_uuid: str, trace: str) -> None:
        """Alias ``child_uuid`` (a shed part, a racer) to its root trace:
        spans recorded under the child resolve into the root's trace."""
        if child_uuid == trace:
            return
        with self._lock:
            self._links[child_uuid] = trace
            while len(self._links) > 4096:
                self._links.popitem(last=False)

    def resolve(self, uuid: Optional[str]) -> Optional[str]:
        """Follow links to the root trace id (cycle-safe).  Walks the live
        map under the lock — no copy; chains are 0-1 hops in practice."""
        with self._lock:
            return self._resolve_locked(uuid, self._links)

    @staticmethod
    def _resolve_locked(uuid, links) -> Optional[str]:
        seen = set()
        while uuid in links and uuid not in seen:
            seen.add(uuid)
            uuid = links[uuid]
        return uuid

    # -- queries -------------------------------------------------------------
    def spans(
        self, uuid: Optional[str] = None, limit: Optional[int] = None
    ) -> list:
        """Recent spans, oldest first.  With ``uuid``, only spans belonging
        to that trace (primary id or ``uuids`` attribution, links
        followed)."""
        with self._lock:
            items = list(self._ring)
            links = dict(self._links)
        if uuid is not None:
            target = self._resolve_locked(uuid, links)
            items = [
                s
                for s in items
                if self._resolve_locked(s["trace"], links) == target
                or any(
                    self._resolve_locked(u, links) == target
                    for u in s["uuids"]
                )
            ]
        if limit is not None:
            items = items[-limit:]
        return [dict(s) for s in items]

    def export(self, uuid: str, limit: int = EXPORT_SPAN_CAP) -> list:
        """The ship-back payload for a result-bearing frame: this node's
        recent spans for ``uuid``'s trace, bounded."""
        return self.spans(uuid, limit=limit)

    def ingest(self, spans) -> int:
        """Merge spans shipped from another node's recorder; invalid
        entries are skipped, duplicates (by span id) dropped.  Returns the
        number actually ingested.  Never raises — this is fed from network
        input."""
        if not isinstance(spans, list):
            return 0
        n = 0
        for s in spans[:INGEST_SPAN_CAP]:
            if not isinstance(s, dict):
                continue
            try:
                span = {
                    "id": str(s["id"]),
                    "trace": None if s.get("trace") is None else str(s["trace"]),
                    "name": str(s["name"]),
                    "site": str(s.get("site", "")),
                    "t0": float(s["t0"]),
                    "t1": float(s["t1"]),
                    "node": str(s.get("node", "remote")),
                    "uuids": [str(u) for u in s.get("uuids", ())][:64],
                    "attrs": {
                        str(k): _json_safe(v)
                        for k, v in (s.get("attrs") or {}).items()
                    },
                }
            except (KeyError, TypeError, ValueError):
                continue
            with self._lock:
                if span["id"] in self._seen:
                    continue
                self._remember_locked(span["id"])
                self._ring.append(span)
                self.remote_spans_ingested += 1
            n += 1
        return n

    # -- exports -------------------------------------------------------------
    def perfetto(self, spans: Optional[list] = None) -> dict:
        """The recent ring (or ``spans``) as Chrome-trace JSON, openable in
        Perfetto / chrome://tracing.  pid = recording node, tid = site
        family; ``args`` carries trace id, uuids, and attrs.  ``ts`` is in
        µs from the top-level ``baseTimeNanoseconds``, the earliest span's
        start (floored to a whole µs) in ns on the recorder's clock, as
        kineto writes its Chrome export: with the default wall clock,
        ``ts * 1000 + baseTimeNanoseconds`` is a span's start on the epoch
        clock that ``torch.profiler`` stamps device events with."""
        if spans is None:
            spans = self.spans()
        pids: dict = {}
        tids: dict = {}
        meta: list = []
        events: list = []
        # Rebase to the earliest span, in whole µs (Chrome-trace ts must be
        # >= 0), and keep the base for another trace of the process to
        # line up with.
        base_us = math.floor(min((s["t0"] for s in spans), default=0.0) * 1e6)
        for s in sorted(spans, key=lambda s: (s["t0"], s["t1"], s["id"])):
            pid = pids.get(s["node"])
            if pid is None:
                pid = pids[s["node"]] = len(pids) + 1
                meta.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": 0,
                        "ts": 0,
                        "args": {"name": s["node"]},
                    }
                )
            family = s["site"].split(".", 1)[0] or "misc"
            tid = tids.get((pid, family))
            if tid is None:
                tid = tids[(pid, family)] = len(tids) + 1
                meta.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "ts": 0,
                        "args": {"name": family},
                    }
                )
            events.append(
                {
                    "name": s["name"],
                    "cat": s["site"],
                    "ph": "X",
                    "ts": int(round(s["t0"] * 1e6)) - base_us,
                    "dur": max(0, int(round((s["t1"] - s["t0"]) * 1e6))),
                    "pid": pid,
                    "tid": tid,
                    "args": {
                        "trace": s["trace"],
                        "uuids": s["uuids"],
                        **s["attrs"],
                    },
                }
            )
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base_us * 1000}

    # -- the flight-recorder dump --------------------------------------------
    def dump(self, reason: str, metrics: Optional[dict] = None) -> Optional[str]:
        """Write the last ``dump_spans`` spans + an optional metrics
        snapshot to ``dump_dir`` (no-op when unset).  Called from failure
        paths (permanent faults, breaker-open transitions), so it must
        never raise — a broken disk must not break recovery."""
        if self.dump_dir is None:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with self._lock:
                n = self.dumps
                self.dumps += 1
                spans = list(self._ring)[-self.dump_spans :]
            path = os.path.join(
                self.dump_dir, f"flightrec-{n:03d}-{reason}.json"
            )
            doc = {
                "reason": reason,
                "node": self.node,
                "at": self.now(),
                "spans": spans,
                "metrics": metrics,
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            return path
        except Exception as e:  # noqa: BLE001 - see docstring
            _LOG.error("[trace] flight-recorder dump failed: %r", e)
            return None

    def metrics(self) -> dict:
        with self._lock:
            return {
                "spans": len(self._ring),
                "ring": self._ring.maxlen,
                "links": len(self._links),
                "dumps": int(self.dumps),
                "remote_spans_ingested": int(self.remote_spans_ingested),
            }


# -- the process-wide seam ----------------------------------------------------
#
# Mirrors serving/faults.py: production runs with no recorder installed and
# every instrumentation point pays one global read + one branch; tests and
# --trace runs install one around a lifetime.

_active: Optional[TraceRecorder] = None


def install(recorder: Optional[TraceRecorder]) -> None:
    global _active
    _active = recorder


def active() -> Optional[TraceRecorder]:
    return _active


@contextlib.contextmanager
def installed(recorder: TraceRecorder):
    """Scope a recorder over a block (tests): always uninstalls."""
    install(recorder)
    try:
        yield recorder
    finally:
        install(None)


# -- call-scoped recordings ---------------------------------------------------


class Recording:
    """One call's spans under one trace id.  Each goes to ``recorder``, the
    installed one, if any; with ``keep`` it is also kept, unbounded and in
    order of end, in ``spans`` (with no recorder, a span dict of the schema
    :meth:`TraceRecorder.record` makes, on the wall clock).  ``counts``
    counts the spans by name, kept or not, and the events of :meth:`count`.
    Spans of one name are recorded on one thread (``solve_bulk``'s drain
    worker has names of its own)."""

    __slots__ = ("recorder", "trace", "keep", "spans", "counts", "now", "_seq")

    def __init__(self, recorder: Optional[TraceRecorder], trace: str, keep: bool):
        self.recorder = recorder
        self.trace = trace
        self.keep = keep
        self.spans: list = []
        self.counts: dict = {}
        self.now: Callable[[], float] = time.time if recorder is None else recorder.now
        self._seq = itertools.count(1)

    def span(self, name: str, site: str, t0: float, **attrs) -> float:
        """Record ``name`` from ``t0`` to now; returns now, which starts
        the next span of a loop (each boundary is read once)."""
        t1 = self.now()
        self.counts[name] = self.counts.get(name, 0) + 1
        if self.recorder is not None:
            span = self.recorder.record(self.trace, name, site, t0, t1, attrs=attrs)
        elif self.keep:
            span = {
                "id": f"local/{next(self._seq)}",
                "trace": self.trace,
                "name": name,
                "site": site,
                "t0": float(t0),
                "t1": float(t1),
                "node": "local",
                "uuids": [],
                "attrs": {k: _json_safe(v) for k, v in attrs.items()},
            }
        if self.keep:
            self.spans.append(span)
        return t1

    def count(self, name: str) -> None:
        """Count one event of ``name`` in ``counts``, recording no span."""
        self.counts[name] = self.counts.get(name, 0) + 1


class _Off:
    """The recording of a call that records nothing: no clock read, no span."""

    __slots__ = ()
    spans = ()
    counts = types.MappingProxyType({})

    def now(self) -> float:
        return 0.0

    def span(self, name: str, site: str, t0: float, **attrs) -> float:
        return 0.0

    def count(self, name: str) -> None:
        pass


OFF = _Off()

_current: contextvars.ContextVar = contextvars.ContextVar("obs.trace.current", default=None)


def current() -> Optional[Recording]:
    """The recording open in this context, or None (the hot loops' seam:
    one context read per call; ``current() or OFF`` records nothing)."""
    return _current.get()


@contextlib.contextmanager
def recording(keep: bool = False):
    """Open a call-scoped :class:`Recording` over the block, under a fresh
    uuid, and yield it.  Its spans go to the installed recorder, and with
    ``keep`` into its ``spans`` as well.  With no recorder installed and
    no ``keep``, nothing is opened: the block gets :data:`OFF` and
    :func:`current` stays None."""
    rec = _active
    if rec is None and not keep:
        yield OFF
        return
    r = Recording(rec, uuid.uuid4().hex, keep)
    token = _current.set(r)
    try:
        yield r
    finally:
        _current.reset(token)
