"""Crash-safe job journal (WAL): the durable half of the job lifecycle.

A serving node that crashes between ``201 Created`` and resolution
silently loses every accepted job — the reference's fault tolerance
(heartbeats, ring repair, re-execution) only covers *remote worker*
death, never the origin process itself.  This module closes that gap
with a write-ahead log over the job lifecycle:

* ``accepted`` — appended by ``SolverEngine.submit`` BEFORE the client
  sees 201: uuid, board, config overrides, deadline, trace id.
* ``resolved`` — appended when a job reaches a REAL verdict (solved /
  unsat / exhausted / cancelled).  Infra errors ("engine stopped", retry
  budget) deliberately do NOT resolve the WAL entry: a crash or drain
  leaves them ``accepted``-only, which is exactly what
  :meth:`Journal.unresolved` replays through the normal submit seam on
  the next boot.  At-least-once is safe because verdicts are
  deterministic and cache fills / cluster dedupe are idempotent by uuid.

Format: segmented JSONL, one self-describing event per line
(``{"kind": "accepted"|"resolved", "uuid": ...}``), torn-tail-tolerant
like ``obs/ordertrace.py`` — a crash mid-write loses at most the final
line, and recovery skips any line that does not parse.  Segments rotate
at ``segment_bytes``; a resolve-driven **compaction** rewrites the live
(unresolved) set into a fresh segment and unlinks the old ones, so disk
stays bounded by the in-flight job count plus one segment of slack.

Durability is *batched off the hot path*, asymmetrically by record
kind.  ``accepted`` is written+flushed synchronously under the journal
lock (microseconds; submit runs on HTTP/client threads, never the
device loop) so a 201 implies the record is at least in the page cache
— the daemon batcher thread (``Journal._fsync_loop``) fsyncs every
``fsync_interval_s``, the declared durability lag.  ``resolved`` MAY
fire from the device loop (``_finish_job``), so it only appends to an
in-memory pending buffer the batcher drains to disk — no file I/O ever
runs on the device loop thread.  A crash that loses a buffered resolve
merely replays an already-resolved job, which is idempotent by design.

Failure doctrine (the ``serving/faults.py`` sites ``journal.append`` /
``journal.fsync``): a full disk or dead file handle **degrades the
journal to non-durable** — a loud counter, one ``[journal]`` log line
per degrade, and every subsequent append dropped — but NEVER fails the
accept path.  Serving without durability beats not serving.

Like faults/brownout, production runs with no journal installed and the
engine's hook sites pay one global read + one branch
(:func:`active` / :func:`install` / :func:`installed`).  Stdlib +
obs.lockdep/logctx + the serving.faults sites only — no jax (the
lint.yml fast lane proves it at import time).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
from typing import Callable, List, Optional

from distributed_sudoku_solver_tpu_torch.obs import lockdep
from distributed_sudoku_solver_tpu_torch.obs.logctx import ctx_log
from distributed_sudoku_solver_tpu_torch.serving import faults

_LOG = logging.getLogger(__name__)

#: Segment filenames sort lexically AND numerically: wal-00000042.jsonl.
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".jsonl"

#: The front-door L1 hot set persists beside the WAL under this name
#: (graceful drain writes it; the next boot restores the cache warm).
FRONTDOOR_SNAPSHOT = "frontdoor_l1.json"


def _seg_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}"


def _seg_index(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def read_segment(path: str) -> List[dict]:
    """All events in one segment, skipping any torn final line (the
    ``obs/ordertrace.py`` recovery contract)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn tail line from a crash mid-write
            if isinstance(ev, dict):
                out.append(ev)
    return out


class Journal:
    """One node's segmented write-ahead log of the job lifecycle.

    ``path`` is a directory (created if missing); segments live inside
    it so a crash-restart harness can kill the process and hand the SAME
    directory to the reborn node.  The injected ``clock`` feeds event
    timestamps (relative, diagnostic-only — recovery never orders by
    them); the batcher thread paces on its own stop event, so no bare
    wall-clock call runs anywhere in the hot path.
    """

    def __init__(
        self,
        path: str,
        segment_bytes: int = 1 << 20,
        fsync_interval_s: float = 0.05,
        compact_min_resolved: int = 64,
        clock: Callable[[], float] = None,
    ):
        self.path = path
        self.segment_bytes = max(4096, int(segment_bytes))
        self.fsync_interval_s = max(0.001, float(fsync_interval_s))
        self.compact_min_resolved = max(1, int(compact_min_resolved))
        self._clock = clock if clock is not None else (lambda: 0.0)
        os.makedirs(path, exist_ok=True)
        self._lock = lockdep.named_lock("serving.journal")  # lockck: name(serving.journal)
        self._fh = None  # lockck: guard(_lock) — active segment handle
        self._seg_index = 0  # lockck: guard(_lock)
        self._seg_bytes = 0  # lockck: guard(_lock)
        self._live = {}  # lockck: guard(_lock) — uuid -> accepted event
        self._pending = []  # lockck: guard(_lock) — resolve events awaiting
        #   the batcher (device-loop-safe buffering, see module docstring)
        self._resolved_since_compact = 0  # lockck: guard(_lock)
        self._durable = True  # lockck: guard(_lock)
        self._dirty = False  # lockck: guard(_lock) — unfsynced writes
        # Counters (all guarded): the journal/lifecycle metrics family.
        self.accepted = 0  # lockck: guard(_lock)
        self.resolved = 0  # lockck: guard(_lock)
        self.recovered = 0  # lockck: guard(_lock)
        self.append_failures = 0  # lockck: guard(_lock)
        self.fsync_failures = 0  # lockck: guard(_lock)
        self.dropped_non_durable = 0  # lockck: guard(_lock)
        self.compactions = 0  # lockck: guard(_lock)
        self.segments_removed = 0  # lockck: guard(_lock)
        with self._lock:
            self._recover_state_locked()
        self._stop = threading.Event()
        self._batcher = threading.Thread(
            target=self._fsync_loop, name="journal-fsync", daemon=True
        )
        self._batcher.start()

    # -- boot-time scan -------------------------------------------------------
    def _segments(self) -> List[str]:
        """Segment file names in append order (oldest first)."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        segs = [(i, n) for n in names if (i := _seg_index(n)) is not None]
        return [n for _, n in sorted(segs)]

    def _recover_state_locked(self) -> None:
        """Replay existing segments into the live map and open the next
        segment for appends (the old tail may be torn — never reopened)."""
        resolved: set = set()
        order: List[str] = []
        live: dict = {}
        last = -1
        for name in self._segments():
            last = max(last, _seg_index(name) or 0)
            for ev in read_segment(os.path.join(self.path, name)):
                kind = ev.get("kind")
                uuid = ev.get("uuid")
                if not uuid:
                    continue
                if kind == "accepted":
                    if uuid not in live:
                        order.append(uuid)
                    live[uuid] = ev
                elif kind == "resolved":
                    resolved.add(uuid)
        for uuid in order:
            if uuid not in resolved and uuid in live:
                self._live[uuid] = live[uuid]
        self._seg_index = last + 1
        self._open_segment_locked()

    def _open_segment_locked(self) -> None:
        path = os.path.join(self.path, _seg_name(self._seg_index))
        self._fh = open(path, "a", encoding="utf-8")
        self._seg_bytes = self._fh.tell()

    # -- the hot path ---------------------------------------------------------
    def _append_locked(self, event: dict) -> None:
        """Write one event (write+flush only; fsync rides the batcher).
        Degrades to non-durable on the first failure — the accept path
        NEVER sees an exception out of here."""
        if not self._durable:
            self.dropped_non_durable += 1
            return
        try:
            faults.fire("journal.append", uuids=(event.get("uuid", ""),))
            line = json.dumps(event, sort_keys=True) + "\n"
            self._fh.write(line)
            self._fh.flush()
            self._seg_bytes += len(line)
            self._dirty = True
            if self._seg_bytes >= self.segment_bytes:
                self._rotate_locked()
        except Exception as e:  # SimulatedFault, OSError (disk full), ...
            self.append_failures += 1
            self._durable = False
            ctx_log(_LOG, "journal", self.path).error(
                "append failed — journal DEGRADED to non-durable "
                "(accepted jobs are no longer crash-safe): %r", e
            )

    def _rotate_locked(self) -> None:
        try:
            self._fsync_locked()
            self._fh.close()
        except Exception:
            pass
        self._seg_index += 1
        self._open_segment_locked()

    def _fsync_locked(self) -> None:
        if not self._dirty or not self._durable:
            return
        try:
            faults.fire("journal.fsync")
            os.fsync(self._fh.fileno())
            self._dirty = False
        except Exception as e:
            self.fsync_failures += 1
            self._durable = False
            ctx_log(_LOG, "journal", self.path).error(
                "fsync failed — journal DEGRADED to non-durable: %r", e
            )

    def _drain_pending_locked(self) -> None:
        """Write out buffered resolve events (batcher/sync/shutdown only —
        never a caller thread)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for ev in pending:
            self._append_locked(ev)

    def _fsync_loop(self) -> None:
        """The batcher daemon: drain buffered resolves, then one fsync per
        interval covers every append since the last — durability off the
        hot path."""
        while not self._stop.wait(self.fsync_interval_s):
            with self._lock:
                self._drain_pending_locked()
                self._fsync_locked()
                if self._resolved_since_compact >= self.compact_min_resolved:
                    self._compact_locked()

    def sync_now(self) -> None:
        """Deterministic flush: drain the pending buffer and fsync NOW
        (drain/shutdown/tests — callers that cannot wait out the batcher
        interval)."""
        with self._lock:
            self._drain_pending_locked()
            self._fsync_locked()

    # -- the lifecycle records ------------------------------------------------
    def record_accepted(
        self,
        uuid: str,
        grid=None,
        config: Optional[dict] = None,
        deadline_s: Optional[float] = None,
        trace: Optional[str] = None,
        roots=None,
        geom: Optional[str] = None,
    ) -> None:
        """The WAL promise: appended before the client's 201.  ``grid`` is
        any nested-list-able board; ``roots`` covers subtask (row-frontier)
        jobs; ``config`` carries only the caller's overrides dict."""
        ev = {"kind": "accepted", "uuid": str(uuid), "t": round(self._clock(), 6)}
        if grid is not None:
            ev["grid"] = [[int(v) for v in row] for row in grid]
        if roots is not None:
            ev["roots"] = [[int(v) for v in row] for row in roots]
        if geom is not None:
            ev["geom"] = geom
        if config:
            ev["config"] = config
        if deadline_s is not None:
            ev["deadline_s"] = float(deadline_s)
        if trace:
            ev["trace"] = trace
        with self._lock:
            if str(uuid) not in self._live:
                self._live[str(uuid)] = ev
            self.accepted += 1
            self._append_locked(ev)

    def record_resolved(self, uuid: str, verdict: Optional[dict] = None) -> None:
        """A REAL verdict reached: the accepted entry is discharged and
        becomes compaction fodder.  Unknown uuids are fine (replays,
        remote parts).  Buffered, not written: this site may run on the
        device loop thread (``_finish_job``), so the disk write rides the
        batcher — a crash-lost buffered resolve only replays an
        already-resolved job, which is idempotent."""
        ev = {"kind": "resolved", "uuid": str(uuid), "t": round(self._clock(), 6)}
        if verdict:
            ev.update({k: verdict[k] for k in sorted(verdict)})
        with self._lock:
            if self._live.pop(str(uuid), None) is not None:
                self._resolved_since_compact += 1
            self.resolved += 1
            self._pending.append(ev)

    def mark_recovered(self, n: int) -> None:
        """Bookkeeping for the boot-time replay (the engine counts what it
        actually re-submitted)."""
        with self._lock:
            self.recovered += int(n)

    # -- recovery / compaction ------------------------------------------------
    def unresolved(self) -> List[dict]:
        """The replay set: every ``accepted`` with no ``resolved``, in
        original accept order — deterministic, so two recover() runs over
        the same directory are byte-identical."""
        with self._lock:
            return [dict(ev) for ev in self._live.values()]

    def compact(self) -> None:
        """Rewrite the live set into a fresh segment and unlink the old
        ones (also the drain-time final flush)."""
        with self._lock:
            self._drain_pending_locked()
            self._compact_locked()

    def _compact_locked(self) -> None:
        if not self._durable:
            self._resolved_since_compact = 0
            return
        old = self._segments()
        try:
            self._fh.close()
        except Exception:
            pass
        self._seg_index += 1
        try:
            self._open_segment_locked()
            for ev in self._live.values():
                line = json.dumps(ev, sort_keys=True) + "\n"
                self._fh.write(line)
                self._seg_bytes += len(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._dirty = False
            for name in old:
                try:
                    os.unlink(os.path.join(self.path, name))
                    self.segments_removed += 1
                except OSError:
                    pass
            self.compactions += 1
        except Exception as e:
            self._durable = False
            ctx_log(_LOG, "journal", self.path).error(
                "compaction failed — journal DEGRADED to non-durable: %r", e
            )
        self._resolved_since_compact = 0

    # -- lifecycle ------------------------------------------------------------
    @property
    def durable(self) -> bool:
        with self._lock:
            return self._durable

    def metrics(self) -> dict:
        with self._lock:
            return {
                "durable": self._durable,
                "accepted": self.accepted,
                "resolved": self.resolved,
                "recovered": self.recovered,
                "unresolved": len(self._live),
                "pending": len(self._pending),
                "append_failures": self.append_failures,
                "fsync_failures": self.fsync_failures,
                "dropped_non_durable": self.dropped_non_durable,
                "compactions": self.compactions,
                "segments_removed": self.segments_removed,
                "segment_index": self._seg_index,
                "fsync_interval_s": self.fsync_interval_s,
            }

    def shutdown(self) -> None:
        """Final fsync + handle close; the directory stays for the next
        boot (that is the whole point).  Named ``shutdown`` (not
        ``close``) so deadck's name-based call resolver never binds other
        modules' file-handle ``close()`` calls to the journal lock."""
        self._stop.set()
        self._batcher.join(timeout=5)
        with self._lock:
            self._drain_pending_locked()
            self._fsync_locked()
            try:
                self._fh.close()
            except Exception:
                pass

    # -- the front-door hot-set sidecar ---------------------------------------
    def save_frontdoor(self, entries: list) -> None:
        """Persist the L1 hot set beside the WAL (graceful drain).  Atomic
        rename so a crash mid-dump leaves the previous snapshot intact."""
        path = os.path.join(self.path, FRONTDOOR_SNAPSHOT)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(entries, fh)
            os.replace(tmp, path)
        except OSError as e:
            ctx_log(_LOG, "journal", self.path).error(
                "front-door snapshot failed (cache restarts cold): %r", e
            )

    def load_frontdoor(self) -> list:
        path = os.path.join(self.path, FRONTDOOR_SNAPSHOT)
        try:
            with open(path, encoding="utf-8") as fh:
                out = json.load(fh)
            return out if isinstance(out, list) else []
        except (OSError, ValueError):
            return []


# -- the process-wide seam ----------------------------------------------------

_active: Optional[Journal] = None


def install(journal: Optional[Journal]) -> None:
    global _active
    _active = journal


def active() -> Optional[Journal]:
    return _active


@contextlib.contextmanager
def installed(journal: Journal):
    """Scope a journal over a block (tests): always uninstalls + closes."""
    install(journal)
    try:
        yield journal
    finally:
        install(None)
        journal.shutdown()
